"""Device-idle time per RT run [ms] while the host was inside the
program's copy-out of the products (`rajepy.rt.products_out`): the card
waiting on the host's memory."""
from benchmark.harness.spans import split


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    got = split(ctx.trace, 'rajepy.rt.products_out')
    return None if got is None else got[1] * 1e3 / ctx.requests
