"""Host time per observed run [ms] writing its observation's products: the
program's spans `rajepy.obs.write` (the clean and noisy visibility sets,
the restored image and every other FITS product) over the traced window's
runs."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, 'rajepy.obs.write')
    return None if got is None else got[0] * 1e3 / ctx.requests
