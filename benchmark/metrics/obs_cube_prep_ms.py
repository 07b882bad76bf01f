"""Host time per observed cube run [ms] in its per-channel preparation: the
program's spans `rajepy.synthobs: cube prep` (each channel's weights,
gridding, FFTs and threshold, launched one channel at a time, and the wait
for them) over the traced window's runs.  None where the window holds no
such span."""
from benchmark.harness.spans import split

SPAN = 'rajepy.synthobs: cube prep'


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, SPAN)
    return None if got is None else got[0] * 1e3 / ctx.requests
