"""Bounds of the end-to-end metrics from two sets of runs of a cell with the
same seeds (``repeat.py --out`` files; a seed's first run is in set 1, its
second in set 2):

    python3 benchmark/tools/bounds.py runs.jsonl [...]

For each metric: each set's spread (quartile distance over the median),
the suggested bound (five times the wider spread, within 1% and 25%),
whether the wider spread is within half of it, the spread with each
set's run farthest from its median left out (the mean of the two is what
a bound must be at least twice), and the second set's median against the
first's."""
import json
import os
import statistics
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness.stats import spread  # noqa: E402


def trimmed(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def main(paths):
    sets = defaultdict(lambda: ([], []))
    seen = defaultdict(set)
    for path in paths:
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                r = rec['result']
                if rec['trace'] or not r:
                    continue
                key = (rec['workload'], rec['seed'])
                which = 1 if key in seen[rec['workload']] else 0
                seen[rec['workload']].add(key)
                for name, m in r['metrics'].items():
                    sets[(rec['workload'], name)][which].append(m['value'])
    for (cell, name), (a, b) in sorted(sets.items()):
        if len(a) < 3 or len(b) < 3:
            print(cell, name, 'needs two sets of at least 3 runs')
            continue
        wide = max(spread(a), spread(b))
        tight = (trimmed(a) + trimmed(b)) / 2
        bound = min(0.25, max(0.01, 5 * wide))
        print(f"{cell} {name}: spreads {spread(a):.4f} {spread(b):.4f}; "
              f"suggested bound {bound:.3f} (<= {8 * wide:.4f}); wider "
              f"spread within half of it: {wide <= bound / 2}; trimmed "
              f"mean {tight:.4f} (bound >= {2 * tight:.4f}); medians "
              f"{statistics.median(a)!r} -> {statistics.median(b)!r} "
              f"({statistics.median(b) / statistics.median(a) - 1:+.4f})")


if __name__ == '__main__':
    main(sys.argv[1:])
