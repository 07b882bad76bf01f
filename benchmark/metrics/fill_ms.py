"""The grid fill of the set-up (`JetModel`'s fields), between CUDA events
[ms]."""


def read(ctx):
    return ctx.setup.get('fill_ms')
