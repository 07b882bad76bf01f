"""Device operations per optimiser step of a fit (forward, backward,
optimiser and the fit's own set-up, over its steps)."""


def read(ctx):
    if ctx.unit != 'step' or not ctx.units:
        return None
    return ctx.trace.op_count() / ctx.units
