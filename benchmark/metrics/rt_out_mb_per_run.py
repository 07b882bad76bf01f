"""Megabytes (1e6 B) per RT run that the program's copy-out moves to the
host: its counters `rt.products_out_bytes` over `rt.runs`, both counted
at the run's end over the process's life (the set-up's warm-up runs have
the window's shapes)."""


def read(ctx):
    if ctx.unit != 'run':
        return None
    from rajepy_tpu_torch.utils import profiling
    counters = getattr(profiling, 'COUNTERS', {})
    runs = counters.get('rt.runs', 0)
    if not runs or 'rt.products_out_bytes' not in counters:
        return None
    return counters['rt.products_out_bytes'] / runs / 1e6
