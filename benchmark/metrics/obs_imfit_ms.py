"""Host time per observed run [ms] in its source fit: the program's spans
`rajepy.obs.imfit` (the estimates from the tau = 1 surface, the host
least-squares fit of the restored image, the summary file) over the traced
window's runs."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, 'rajepy.obs.imfit')
    return None if got is None else got[0] * 1e3 / ctx.requests
