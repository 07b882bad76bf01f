"""Host time per optimiser step [ms] inside the optimiser's step
(`rajepy.fit.optimizer`)."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'step' or not ctx.units:
        return None
    got = split(ctx.trace, 'rajepy.fit.optimizer')
    return None if got is None else got[0] * 1e3 / ctx.units
