"""Device time per RT run [ms] of every kernel but a copy, a set and the
two hand-written kernels that the roofline metrics read (K2
`epoch_maps_kernel<2>`, K4 `rrl_tiles_kernel`): the eager channel stage
of ops/radtrans, ops/rrls and ops/gaunt, with the run's other eager
operations.  The list is the benchmark's own: a kernel that takes over
part of the stage stays in it."""
EXCLUDED = ('Memcpy', 'Memset', 'epoch_maps_kernel<2>', 'rrl_tiles_kernel')


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    s = ctx.trace.op_seconds(lambda n: not any(k in n for k in EXCLUDED))
    return s * 1e3 / ctx.requests if s > 0 else None
