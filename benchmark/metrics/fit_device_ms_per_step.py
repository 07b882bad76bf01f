"""Device busy time per optimiser step of a fit [ms]: the union of every
operation's interval on the card over the traced fit, over its steps."""


def read(ctx):
    if ctx.unit != 'step' or not ctx.units:
        return None
    return ctx.trace.busy_s() * 1e3 / ctx.units
