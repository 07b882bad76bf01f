"""Host time per RT run [ms] inside the program's copy-out of the
products to numpy (`rajepy.rt.products_out`), the wait for the run's
queued kernels included."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, 'rajepy.rt.products_out')
    return None if got is None else got[0] * 1e3 / ctx.requests
