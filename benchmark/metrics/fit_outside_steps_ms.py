"""Host time of a fit outside its optimiser steps [ms], over its steps:
inside `rajepy.fit.run` and outside every `rajepy.fit.step` (the fit's
build and finish)."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'step' or not ctx.units:
        return None
    got = split(ctx.trace, 'rajepy.fit.run', ('rajepy.fit.step',))
    return None if got is None else got[0] * 1e3 / ctx.units
