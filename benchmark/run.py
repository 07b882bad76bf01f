"""Run one cell of the benchmark of rajepy_tpu_torch once, on the card
this process sees:

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

The last line of standard output is the result (JSON); the numbers that
decide ``correct`` are the last lines of standard error.  Without a CUDA
card with the chips the cell asks for, it exits with code 2 and prints no
result; with a forbidden module loaded (JAX or the JAX package), code 3.
"""
import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Every build and kernel cache at a fixed directory of the
    checkout."""
    cache = os.path.join(ROOT, '_bench_cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache,
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    from benchmark.harness import core
    t_process = core.process_start()
    import torch
    chips = core.Spec(ROOT).cell(args.workload)['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    out = core.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), 'cuda', t_process)
    bad = core.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out['checks'].items():
        ok = c['value'] <= c['limit'] and not math.isnan(c['value'])
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
