"""Device time of the copies to the host per RT run [ms]: the products
out (`as_numpy=True`)."""


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    s = ctx.trace.op_seconds(lambda n: 'DtoH' in n)
    return s * 1e3 / ctx.requests if s > 0 else None
