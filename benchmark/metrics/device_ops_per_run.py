"""Device operations (kernels, copies, sets) per RT run in the traced
window: the eager launches of the run entry and its channel stage."""


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    return ctx.trace.op_count() / ctx.requests
