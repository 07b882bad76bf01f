"""Host time per observed run [ms] in its imaging: the program's spans
`rajepy.obs.image` (Briggs weights, gridding, FFT to the dirty image and
PSF, their copy to the host and the CLEAN threshold, the wait for the device
included) over the traced window's runs."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, 'rajepy.obs.image')
    return None if got is None else got[0] * 1e3 / ctx.requests
