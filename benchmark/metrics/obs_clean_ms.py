"""Host time per observed run [ms] in its CLEAN minor cycle: the program's
spans `rajepy.obs.clean` (Hogbom's gated iterations and the host's reads
of the stop condition, the wait for the device included) over the traced
window's runs."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, 'rajepy.obs.clean')
    return None if got is None else got[0] * 1e3 / ctx.requests
