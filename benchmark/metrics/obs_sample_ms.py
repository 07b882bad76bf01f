"""Host time per observed run [ms] in its sampling: the program's spans
`rajepy.obs.sample` (FFT and Kaiser-Bessel degridding of the sky map at the
uv tracks, thermal noise, the sets' copy to the host, the wait for the
device included) over the traced window's runs."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, 'rajepy.obs.sample')
    return None if got is None else got[0] * 1e3 / ctx.requests
