"""Share (%) of the program's Faddeeva evaluations (``ops/voigt.wofz``)
that its CUDA kernel made: 100 x the program's counter
``voigt.wofz_kernel`` over ``voigt.wofz_evals``, over the process's life
(the set-up's warm fit included).  None where the program keeps no such
counter, or has made no evaluation."""


def read(ctx):
    from rajepy_tpu_torch.utils import profiling
    counters = getattr(profiling, 'COUNTERS', {})
    evals = counters.get('voigt.wofz_evals', 0)
    if not evals:
        return None
    return 100.0 * counters.get('voigt.wofz_kernel', 0) / evals
