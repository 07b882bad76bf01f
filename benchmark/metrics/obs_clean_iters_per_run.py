"""Hogbom iterations per observed run in the traced window: the advance of
the program's counters `obs.clean_iterations` over that of `obs.runs` in the
window's requests (the workload keeps each request's advance).  None where
the program keeps no such counters."""


def read(ctx):
    deltas = getattr(ctx.workload, 'deltas', None)
    if ctx.unit != 'run' or not deltas or not ctx.requests:
        return None
    window = deltas[-ctx.requests:]
    runs = sum(d.get('obs.runs', 0) for d in window)
    if not runs:
        return None
    return sum(d.get('obs.clean_iterations', 0) for d in window) / runs
