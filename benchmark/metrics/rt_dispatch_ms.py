"""Host time per RT run [ms] inside the program's run entry
(`rajepy.rt.run`) and outside its copy-out (`rajepy.rt.products_out`):
the statics, epoch maps, line opacity and channel stage as the host
issues them."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, 'rajepy.rt.run', ('rajepy.rt.products_out',))
    return None if got is None else got[0] * 1e3 / ctx.requests
