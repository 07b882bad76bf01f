"""Host time per observed run [ms] outside its observation: the benchmark's
request spans less the program's `rajepy.obs.run` (the RT run, the copy-out,
the three FITS products and the pipeline's state), over the traced window's
runs.  None where the window holds no observation."""
from benchmark.harness.spans import intervals, split
from benchmark.harness.trace import REQUEST_SPAN

OBS = 'rajepy.obs.run'


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests or \
            not intervals(ctx.trace, OBS):
        return None
    got = split(ctx.trace, REQUEST_SPAN, (OBS,))
    return None if got is None else got[0] * 1e3 / ctx.requests
