"""K2's share of its roofline [%]: the least time the card needs for one
run's epoch maps (benchmark/counts/epoch_maps.py, at the card's published
peaks) over the profiler's device time per run of `epoch_maps_kernel<2>`
(csrc/epoch_maps.cu)."""
from benchmark.counts.epoch_maps import k2
from benchmark.harness.peaks import bound_ms

KERNEL = 'epoch_maps_kernel<2>'


def read(ctx):
    if ctx.unit != 'run' or not ctx.requests:
        return None
    s = ctx.trace.op_seconds(lambda n: KERNEL in n)
    if s <= 0:
        return None
    w = ctx.workload
    n_bytes, ops = k2(w.params, w.device)
    return 100.0 * bound_ms(ctx.device_kind, n_bytes, ops) / (
        s * 1e3 / ctx.requests)
