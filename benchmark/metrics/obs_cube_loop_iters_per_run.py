"""Iterations of the cube CLEAN's batched loop per observed run in the
traced window (each block's most, summed: what sets its launches): the
advance of the program's counter `obs.cube_loop_iterations` over that of
`obs.runs` in the window's requests (the workload keeps each request's
advance of the counters the program keeps).  None where the program keeps
no such counter."""


def read(ctx):
    deltas = getattr(ctx.workload, 'deltas', None)
    if ctx.unit != 'run' or not deltas or not ctx.requests:
        return None
    window = deltas[-ctx.requests:]
    runs = sum(d.get('obs.runs', 0) for d in window)
    if not runs or not any('obs.cube_loop_iterations' in d for d in window):
        return None
    return sum(d.get('obs.cube_loop_iterations', 0) for d in window) / runs
