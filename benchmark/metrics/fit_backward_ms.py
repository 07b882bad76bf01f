"""Host time per optimiser step [ms] inside the fit's gradient
(`rajepy.fit.backward`: autograd, which recomputes what the forward
did not keep)."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'step' or not ctx.units:
        return None
    got = split(ctx.trace, 'rajepy.fit.backward')
    return None if got is None else got[0] * 1e3 / ctx.units
