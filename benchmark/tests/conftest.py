"""Fixtures of the benchmark's tests: the repository root on the path,
the ``cuda`` marker, and a copy of the benchmark's data files cut to a
size the CPU runs in seconds."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_GRID = (24, 60, 24)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


def tiny_root(path):
    """``BENCHMARK.json`` and the benchmark's data files under ``path``,
    the grids cut to :data:`TINY_GRID`, the line cube to 10 channels over
    2e7 Hz about the line, the fits to 4 steps and the traced windows to 2
    requests."""
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), path)
    src = os.path.join(ROOT, 'benchmark')
    dst = os.path.join(str(path), 'benchmark')
    for sub in ('configs', 'traffic', 'kinds', 'limits', 'metrics'):
        shutil.copytree(os.path.join(src, sub), os.path.join(dst, sub))
    for name in os.listdir(os.path.join(dst, 'configs')):
        _edit(os.path.join(dst, 'configs', name), lambda c: c['grid'].update(
            n_x=TINY_GRID[0], n_y=TINY_GRID[1], n_z=TINY_GRID[2], l_z=None))

    def mix(m):
        m['trace_requests'] = min(m['trace_requests'], 2)
        if 'channels' in m and 'bandwidth_hz' in m['channels']:
            m['channels'].update(bandwidth_hz=2e7, chanwidth_hz=2e6)
        if 'steps' in m:
            m['steps'] = 4
    for name in os.listdir(os.path.join(dst, 'traffic')):
        _edit(os.path.join(dst, 'traffic', name), mix)
    return str(path)


def _edit(path, fn):
    with open(path) as f:
        d = json.load(f)
    fn(d)
    with open(path, 'w') as f:
        json.dump(d, f)


@pytest.fixture()
def tiny(tmp_path):
    """A :class:`benchmark.harness.core.Spec` of the tiny copy."""
    from benchmark.harness.core import Spec
    return Spec(tiny_root(tmp_path))


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return 'cuda'
