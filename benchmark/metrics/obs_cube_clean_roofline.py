"""The cube CLEAN's share of its roofline [%]: the least time the card
needs for the traced runs' CLEAN (benchmark/counts/clean_cube.py: the
channel-iterations of the program's counter `obs.clean_iterations`, the
cell's channels, image and CLEAN mask, at the card's published bandwidth)
over the card's busy time inside the program's spans `rajepy.synthobs:
cube CLEAN` (each ends with a wait for its block's CLEAN, so the CLEAN's
operations end inside it).  None where the window holds no such span, no
device operation in it, or no counters."""
from benchmark.counts.clean_cube import least_bytes
from benchmark.harness.peaks import bound_ms
from benchmark.harness.spans import split

SPAN = 'rajepy.synthobs: cube CLEAN'


def read(ctx):
    w = ctx.workload
    deltas = getattr(w, 'deltas', None)
    geometry = getattr(w, 'cube_geometry', None)
    if ctx.unit != 'run' or not ctx.requests or not deltas or \
            geometry is None:
        return None
    got = split(ctx.trace, SPAN)
    if got is None or got[0] <= got[1]:
        return None
    window = deltas[-ctx.requests:]
    runs = sum(d.get('obs.runs', 0) for d in window)
    iters = sum(d.get('obs.clean_iterations', 0) for d in window)
    if not runs:
        return None
    n, h_y, h_x, n_chan = geometry
    least_ms = bound_ms(ctx.device_kind,
                        least_bytes(n, h_y, h_x, n_chan * runs, iters), 0.0)
    return 100.0 * least_ms / ((got[0] - got[1]) * 1e3)
