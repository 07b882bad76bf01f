"""One run of one cell: set-up, the measured window (or the traced one),
the check against the reference, and the result line.  Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is
found by its name in ``BENCHMARK.json``:

* ``configs[].file``: the configuration;
* ``benchmark/traffic/<traffic>.json``: the traffic mix, data;
* ``benchmark/kinds/<kind>.py``: the ``Workload`` that serves the mix's
  ``kind`` of request;
* ``benchmark/limits/<workload>.json``: the cell's limits on the numbers
  that decide ``correct``;
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(ctx) -> float | None``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
import time
import traceback
from typing import Dict, List, Optional

import torch

from . import stats
from .trace import REQUEST_SPAN, Trace
from .workloads import kind_class

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'rajepy_tpu')

END_TO_END = {
    'setup_s': lambda w: w['setup_s'],
    'runs_per_s': lambda w: stats.rate(w['done'], w['window_s']),
    'run_p95_ms': lambda w: stats.p95(w['latencies']) * 1e3,
    'fit_step_ms': lambda w: stats.per_step_ms(w['window_s'], w['units']),
    'peak_mem_gib': lambda w: w['peak_bytes'] / 2 ** 30,
}


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench = _json(os.path.join(root, 'BENCHMARK.json'))

    def cell(self, name: str) -> Dict:
        for w in self.bench['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: Dict) -> Dict:
        cfg, = (c for c in self.bench['configs']
                if c['name'] == cell['config'])
        return _json(os.path.join(self.root, cfg['file']))

    def traffic(self, cell: Dict) -> Dict:
        return _json(os.path.join(self.root, 'benchmark', 'traffic',
                                  cell['traffic'] + '.json'))

    def workload(self, cell: Dict, seed: int, device: str):
        """The cell's workload: its mix's kind over its configuration."""
        mix = self.traffic(cell)
        return kind_class(self.root, mix['kind'])(self.config(cell), mix,
                                                  seed, device)

    def limits(self, cell: Dict) -> Dict[str, float]:
        return _json(os.path.join(self.root, 'benchmark', 'limits',
                                  cell['name'] + '.json'))

    def metrics(self, cell: Dict, kind: str) -> List[Dict]:
        """The cell's ``end_to_end`` or ``per_layer`` metrics."""
        return [m for m in self.bench[kind]
                if cell['name'] in m.get('workloads', [cell['name']])]


def reader(name: str, root: str = ROOT):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, 'benchmark', 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'benchmark.metrics.' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_start() -> float:
    """This process's start on the epoch clock [s] (Linux /proc), or the
    first call of this function elsewhere."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/stat') as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith('btime'))
        return btime + ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, StopIteration):
        return time.time()


class Context:
    """What a per-layer metric's reader gets: the trace of the traced
    window, the requests and units (runs or optimiser steps) it holds,
    the set-up's readings, the workload, and the card's name."""

    def __init__(self, trace: Trace, requests: int, units: int,
                 setup: Dict, workload, device_kind: str):
        self.trace, self.requests, self.units = trace, requests, units
        self.setup, self.workload = setup, workload
        self.device_kind = device_kind
        self.unit = workload.unit


def _serve(workload, seconds: float, n_requests: Optional[int] = None,
           step=None) -> Dict:
    """Closed loop, one client: requests back to back until ``seconds``
    have passed (the last one finishes), or ``n_requests`` of them."""
    from torch.profiler import record_function
    lat, units, attempted, failed = [], [], 0, 0
    t_start = time.perf_counter()
    t_end = t_start
    while (attempted < n_requests if n_requests is not None
           else t_end - t_start < seconds):
        attempted += 1
        t0 = time.perf_counter()
        try:
            with record_function(REQUEST_SPAN):
                u = workload.request()
        except Exception:                      # a request that fails is
            failed += 1                        # counted and reported
            traceback.print_exc(file=sys.stderr)
            u = None
        t_end = time.perf_counter()
        if u is not None:
            lat.append(t_end - t0)
            units.append(u)
        if step is not None:
            step()
    return {'latencies': lat, 'units': sum(units), 'unit_list': units,
            'attempted': attempted, 'failed': failed, 'done': len(lat),
            'window_s': t_end - t_start}


def _device(device: str, chips: int) -> Dict:
    if device == 'cpu':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': chips,
            'memory_peak_bytes': int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool,
             device: str = 'cuda', t_process: Optional[float] = None,
             spec: Optional[Spec] = None) -> Dict:
    """One run of a cell; returns the result line's object (with the
    checks last)."""
    spec = spec or Spec()
    cell = spec.cell(workload_name)
    limits = spec.limits(cell)
    mix = spec.traffic(cell)
    w = spec.workload(cell, seed, device)
    info = w.setup()
    if trace:
        holder = []
        from torch.profiler import ProfilerActivity, profile, schedule
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device != 'cpu' else [])
        n = mix['trace_requests']
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=n, repeat=1),
                     on_trace_ready=lambda p: holder.append(
                         Trace.from_profile(p))) as prof:
            win = _serve(w, seconds, n_requests=n + 1, step=prof.step)
    else:
        t_first = time.time()
        win = _serve(w, seconds)
        # the benchmark's own reference in set-up is not the program's
        win['setup_s'] = (t_first - (t_process or t_first)
                          - info.get('reference_s', 0.0))
    dev = _device(device, cell['chips'])
    win['peak_bytes'] = dev['memory_peak_bytes']
    w.release()
    if device != 'cpu':
        torch.cuda.empty_cache()
    checks = w.check() if win['done'] else {n: math.inf for n in limits}
    metrics = {}
    if trace:
        tr, = holder
        # the first request warmed the profiler and is not in the trace
        ctx = Context(tr, win['done'] - 1, sum(win['unit_list'][1:]),
                      info, w, dev['kind'])
        for m in spec.metrics(cell, 'per_layer'):
            v = reader(m['name'], spec.root)(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        dev['busy_s'] = tr.busy_s()
        dev['window_s'] = tr.window_s
    else:
        for m in spec.metrics(cell, 'end_to_end'):
            metrics[m['name']] = {'value': END_TO_END[m['name']](win),
                                  'unit': m['unit']}
    if set(checks) != set(limits):
        raise KeyError(f"checks {sorted(checks)} but limits "
                       f"{sorted(limits)}")
    ok = all(checks[n] <= limits[n] for n in limits)   # NaN fails
    out = {'correct': bool(ok and win['failed'] == 0 and win['done'] > 0),
           'attempted': win['attempted'], 'failed': win['failed'],
           'metrics': metrics, 'device': dev}
    if win['latencies']:
        # (not read by the checks: how the window's requests spread)
        q = statistics.quantiles(win['latencies'], n=10) \
            if len(win['latencies']) > 1 else win['latencies'] * 9
        out['window'] = {'requests': win['done'], 'seconds': win['window_s'],
                         'latency_deciles_ms': [v * 1e3 for v in q],
                         'latency_max_ms': max(win['latencies']) * 1e3}
    if trace:
        out['breakdown'] = {'device_ops': tr.top_ops(10),
                            'idle_gaps': tr.idle_gaps(10)}
    out['checks'] = {n: {'value': checks[n], 'limit': limits[n]}
                     for n in limits}
    return out


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))
