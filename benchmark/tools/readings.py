"""The two readings that a cell's limits are set between, in one process:
the program's (a run's set-up, ``--requests`` requests and its check, for
each seed; the lower reading is the largest) and the control's (the plain
reference computed in the precision below the configuration's, bfloat16
below the runs' float32 and float32 below the fits' float64, put in the
program's place and compared with the float64 reference exactly as a
run's answers are; the upper reading is the smallest, and it must fail
the cell's limits):

    python3 benchmark/tools/readings.py --workload <cell> \
        --seeds 1,2,3,... --control-seeds 7,8,9 [--requests 1]

Each seed's readings are a JSON line; the last line holds both readings
and the cell's limits."""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness.core import Spec  # noqa: E402


def program(spec, cell, seed, device, requests):
    """The program's readings of one seed: {check: gap}."""
    w = spec.workload(cell, seed, device)
    w.setup()
    for _ in range(requests):
        w.request()
    w.release()
    return w.check()


def control(workload: str, seed: int, device: str, spec=None):
    """The control's readings of one seed: {check: gap}."""
    spec = spec or Spec(ROOT)
    w = spec.workload(spec.cell(workload), seed, device)
    return w.control(w.control_dtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--requests', type=int, default=1)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    lower, upper = {}, {}
    for side, seeds in (('program', args.seeds),
                        ('control', args.control_seeds)):
        for seed in (int(s) for s in seeds.split(',') if s):
            if side == 'program':
                gaps = program(spec, cell, seed, args.device, args.requests)
            else:
                gaps = control(args.workload, seed, args.device, spec)
            print(json.dumps({'workload': args.workload, 'side': side,
                              'seed': seed, 'gaps': gaps}), flush=True)
            for n, v in gaps.items():
                if side == 'program':
                    lower[n] = max(lower.get(n, 0.0), v)
                else:
                    upper[n] = min(upper.get(n, float('inf')), v)
    limits = spec.limits(cell)
    fails = any(upper.get(n, 0.0) > limits[n] for n in limits)
    print(json.dumps({'workload': args.workload, 'lower': lower,
                      'upper': upper, 'limits': limits,
                      'control_fails': fails if upper else None}))
    return 0 if fails or not upper else 1


if __name__ == '__main__':
    sys.exit(main())
