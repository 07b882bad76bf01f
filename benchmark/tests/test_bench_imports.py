"""Nothing the benchmark loads is JAX or the JAX package (module names
compared by their whole top-level name: the port's name begins with the
JAX package's), and the reference loads nothing of the program."""
import glob
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'rajepy_tpu'}


def _loaded(code):
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys\nprint(" ".join(sorted('
         '{m.split(".")[0] for m in sys.modules})))'],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_metrics_and_tools_load_no_jax():
    metrics = sorted(glob.glob(os.path.join(ROOT, 'benchmark', 'metrics',
                                            '*.py')))
    kinds = sorted(glob.glob(os.path.join(ROOT, 'benchmark', 'kinds',
                                          '*.py')))
    code = ('from benchmark.harness.workloads import kind_class\n'
            'import benchmark.harness.core as c, benchmark.counts.epoch_maps,'
            ' benchmark.counts.rrl_maps\n'
            'import benchmark.tools.readings, benchmark.tools.repeat\n'
            'import rajepy_tpu_torch, rajepy_tpu_torch.fit\n'
            + ''.join(f'c.reader({os.path.basename(m)[:-3]!r})\n'
                      for m in metrics)
            + ''.join(f'kind_class({ROOT!r}, {os.path.basename(k)[:-3]!r})\n'
                      for k in kinds))
    mods = _loaded(code)
    assert 'rajepy_tpu_torch' in mods and not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _loaded('import benchmark.reference.jet, '
                   'benchmark.reference.rrl_fit')
    assert not mods & (FORBIDDEN | {'rajepy_tpu_torch'})


def test_a_run_leaves_no_forbidden_module(tmp_path):
    code = (f'import sys\nsys.path[:0] = [{ROOT!r}, '
            f'{os.path.join(ROOT, "benchmark", "tests")!r}]\n'
            'from conftest import tiny_root\n'
            'from benchmark.harness import core\n'
            f'spec = core.Spec(tiny_root({str(tmp_path)!r}))\n'
            'out = core.run_cell("example_jet_shipped.sed16_runs", 3, 0.1, '
            'False, "cpu", spec=spec)\n'
            'assert out["correct"] and core.forbidden_modules() == []\n')
    mods = _loaded(code)
    assert 'rajepy_tpu_torch' in mods and not mods & FORBIDDEN


def test_run_refuses_without_a_card():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                        'example_jet_shipped.sed16_runs', '--seed', '1',
                        '--seconds', '1'], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode == 2 and p.stdout.strip() == ''
