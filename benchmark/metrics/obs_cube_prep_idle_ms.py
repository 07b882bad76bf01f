"""Device-idle time per observed cube run [ms] inside the program's spans
`rajepy.synthobs: cube prep`: the card waiting on the host's launches and
syncs of the per-channel preparation.  None where the window holds no
such span."""
from benchmark.harness.spans import split

SPAN = 'rajepy.synthobs: cube prep'


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, SPAN)
    return None if got is None else got[1] * 1e3 / ctx.requests
