"""Share of the traced window [%] in which nothing (no kernel, copy or set)
ran on the card, in the cells of RT runs: the host's dispatch around and
within `JetModel`'s run entry."""


def read(ctx):
    if ctx.unit != 'run':
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
