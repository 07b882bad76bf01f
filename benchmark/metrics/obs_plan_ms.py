"""Host time per observed run [ms] in its uv plan: the program's spans
`rajepy.obs.plan` (elevation window, scans, uv tracks, the sky map's read,
image geometry, noise level) over the traced window's runs."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, 'rajepy.obs.plan')
    return None if got is None else got[0] * 1e3 / ctx.requests
