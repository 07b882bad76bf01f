"""Share (%) of the maps that the traced window's RT runs copied out whose
pinned host block was recycled rather than made: 1 - blocks made / maps
copied, in the window.  Blocks made: the program's host spans
``rajepy.host_pool.new_block`` that start in the window.  Maps copied:
the window's runs times the program's counters ``rt.products_out_maps``
over ``rt.runs`` (maps a run, over the process's life).  None where the
program keeps no pinned copy-out counter."""
NEW_BLOCK = 'rajepy.host_pool.new_block'


def read(ctx):
    if ctx.unit != 'run' or not ctx.units:
        return None
    from rajepy_tpu_torch.utils import profiling
    counters = getattr(profiling, 'COUNTERS', {})
    maps, runs = counters.get('rt.products_out_maps', 0), \
        counters.get('rt.runs', 0)
    if not maps or not runs:
        return None
    lo, hi = ctx.trace.window
    made = sum(1 for n, s, _ in ctx.trace.host
               if n == NEW_BLOCK and lo <= s <= hi)
    return 100.0 * (1.0 - made / (ctx.units * maps / runs))
