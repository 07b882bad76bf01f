"""Host time per observed cube run [ms] in its channel-batched CLEAN: the
program's spans `rajepy.synthobs: cube CLEAN` (each block's gated Hogbom
iterations, the host's reads of the stop condition and the wait for the
device) over the traced window's runs.  None where the window holds no
such span."""
from benchmark.harness.spans import split

SPAN = 'rajepy.synthobs: cube CLEAN'


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, SPAN)
    return None if got is None else got[0] * 1e3 / ctx.requests
