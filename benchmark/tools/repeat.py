"""Run one cell several times, each run a process of its own, and report
each metric's runs, median and spread (the distance between the first and
third quartile as a share of the median), and the checks' readings:

    python3 benchmark/tools/repeat.py --workload <cell> --seeds 1,2,3 \
        --seconds 51 [--trace 1] [--out runs.jsonl]

Each run's result line, exit code and the end of its standard error go to
``--out`` as one JSON line."""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness.stats import spread  # noqa: E402


def run(workload, seed, seconds, trace):
    t0 = time.time()
    p = subprocess.run([sys.executable, os.path.join(ROOT, 'benchmark',
                                                     'run.py'),
                        '--workload', workload, '--seed', str(seed),
                        '--seconds', str(seconds), '--trace', str(trace)],
                       cwd=ROOT, capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if p.returncode == 0 else None
    except (IndexError, json.JSONDecodeError):
        result = None
    return {'workload': workload, 'seed': seed, 'seconds': seconds,
            'trace': trace, 'rc': p.returncode, 'wall_s': time.time() - t0,
            'result': result, 'stderr_tail': p.stderr[-3000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, default=0)
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    recs = []
    for seed in (int(s) for s in args.seeds.split(',')):
        rec = run(args.workload, seed, args.seconds, args.trace)
        recs.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, 'a') as f:
                f.write(json.dumps(rec) + '\n')
        r = rec['result']
        print(f"seed {seed} rc {rec['rc']} wall {rec['wall_s']:.1f} s "
              f"correct {r and r['correct']} "
              + (' '.join(f"{k}={v['value']!r}" for k, v in
                          r['metrics'].items()) if r else '')
              + (' | ' + ' '.join(f"{k}={v['value']:.3e}" for k, v in
                                  r['checks'].items()) if r else ''),
              flush=True)
        if rec['rc'] != 0 or r is None:
            print(rec['stderr_tail'][-2000:], flush=True)
    done = [r['result'] for r in recs if r['result']]
    for name in (done[0]['metrics'] if done else {}):
        vals = [r['metrics'][name]['value'] for r in done]
        sp = spread(vals) if len(vals) >= 2 else float('nan')
        print(f"{name}: median {statistics.median(vals)!r} spread {sp:.4f} "
              f"runs {vals}")
    return 0 if all(r['rc'] == 0 for r in recs) else 1


if __name__ == '__main__':
    sys.exit(main())
