"""Share (%) of the program's LTE channel stages of RRL runs
(``kernels.rrl_flux_maps``) that its CUDA kernel made: 100 x the program's
counter ``rt.rrl_flux_kernel`` over ``rt.rrl_flux_stages``, over the
process's life (the set-up's warm runs included).  None where the program
keeps no such counter, or has run no such stage."""


def read(ctx):
    from rajepy_tpu_torch.utils import profiling
    counters = getattr(profiling, 'COUNTERS', {})
    stages = counters.get('rt.rrl_flux_stages', 0)
    if not stages:
        return None
    return 100.0 * counters.get('rt.rrl_flux_kernel', 0) / stages
