"""Share of the traced window [%] in which nothing ran on the card, in the
cells of fits: the host's dispatch of the fit's step loop."""


def read(ctx):
    if ctx.unit != 'step':
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
