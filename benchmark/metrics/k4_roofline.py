"""K4's share of its roofline [%]: the least time the card needs for one
run's line-opacity maps (benchmark/counts/rrl_maps.py, at the card's
published peaks, at the first sampled run's epoch) over the profiler's
device time per run of `rrl_tiles_kernel` (csrc/rrl_maps.cu)."""
from benchmark.counts.rrl_maps import k4
from benchmark.harness.peaks import bound_ms

KERNEL = 'rrl_tiles_kernel'


def read(ctx):
    w = ctx.workload
    if ctx.unit != 'run' or not ctx.requests or w.line is None:
        return None
    s = ctx.trace.op_seconds(lambda n: KERNEL in n)
    if s <= 0:
        return None
    epoch = w.sample.items[0][0]
    n_bytes, ops = k4(w.params, w.line, w.freqs, epoch, w.device)
    return 100.0 * bound_ms(ctx.device_kind, n_bytes, ops) / (
        s * 1e3 / ctx.requests)
