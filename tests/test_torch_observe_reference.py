"""An observed continuum run of the port, reached through
``Pipeline.execute_run``, held stage by stage against the plain reference
of the observation chain (``benchmark/reference/observe.py``, float64) on
the CPU, with the limits of the benchmark's cell
``example_jet_512.observe_vla_a``:

* a 64^2 jet sky (64^3 cells), the bundled campaign's VLA A run at 6 GHz
  in 2 channels with 4 time samples a scan, niter 50 (the image keeps the
  program's floor of 500 pixels): the flux map, the clean visibilities,
  the noise, the dirty image and PSF, Hogbom's model and residual, the
  restored image and the source fit, each from the run's own inputs to it;
* the reference's own chain in float32 in the program's place fails at
  least one of the limits;
* ``execute()`` over a two-run campaign writes the same products, bit for
  bit, as ``execute_run`` on each run.
"""
import copy
import importlib
import json
import os

import numpy as np
import pytest
import torch

from rajepy_tpu_torch import JetModel, Pipeline
from rajepy_tpu_torch.utils import profiling
from tests.torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = 'example_jet_512.observe_vla_a'
CONFIG = 'example_jet_512_vla_a'
SYNTHOBS = {'save_products': ['psf', 'dirty', 'model', 'residual'],
            'max_time_samples': 4, 'niter': 50}
obs = importlib.import_module('benchmark.kinds.observe_runs')


def _json(*path):
    with open(os.path.join(ROOT, 'benchmark', *path)) as f:
        return json.load(f)


LIMITS = _json('limits', CELL + '.json')
MIX = dict(_json('traffic', 'observe_vla_a.json'), synthobs=SYNTHOBS)


@pytest.fixture(scope='module')
def config():
    """The cell's configuration on 64^3 cells."""
    c = _json('configs', CONFIG + '.json')
    c['grid'].update(n_x=64, n_y=64, n_z=64)
    return c


@pytest.fixture(scope='module')
def params(config):
    from benchmark.harness.workloads import model_params
    return model_params(config)


def _pipeline(config, params, dcy, times=None):
    pp = obs.campaign(config, MIX, str(dcy))
    if times is not None:
        pp['continuum']['times'] = np.asarray(times, float)
    return Pipeline(JetModel(copy.deepcopy(params), device='cpu'), pp)


@pytest.fixture(scope='module')
def gaps(config, params, tmp_path_factory):
    """The gaps of one observed run (the campaign's second, 1 yr)."""
    pl = _pipeline(config, params, tmp_path_factory.mktemp('observed'))
    before = profiling.COUNTERS.get('obs.clean_iterations', 0)
    pl.execute_run(1, plot=False, resume=False, clobber=True)
    run = pl.runs[1]
    files = {k: os.path.relpath(v, run.rt_dcy)
             for k, v in run.products.items() if k in obs.PRODUCTS}
    files['flux'] = os.path.basename(run.fits_flux)
    got = obs.read_products(
        run.rt_dcy, files,
        profiling.COUNTERS['obs.clean_iterations'] - before)
    w = obs.Workload(config, MIX, 5, 'cpu')
    return obs.compare(got, w.flux(1), w.setup_ref, 'cpu')


@pytest.mark.parametrize('check', sorted(LIMITS))
def test_observed_run_meets_the_reference(gaps, check):
    assert set(gaps) == set(LIMITS)
    assert gaps[check] <= LIMITS[check], (check, gaps[check])


def test_float32_reference_fails_a_limit(config):
    w = obs.Workload(config, MIX, 5, 'cpu')
    control = w.control(torch.float32)
    assert set(control) == set(LIMITS)
    assert any(control[n] > LIMITS[n] for n in LIMITS), control


def _products(pl):
    """Every product of every run: FITS and text files by their bytes,
    visibility sets by their arrays (a zip member carries its time)."""
    out = {}
    for run in pl.runs:
        for dirpath, _, names in os.walk(run.rt_dcy):
            for name in names:
                path = os.path.join(dirpath, name)
                key = os.path.relpath(path, pl.dcy)
                if name.endswith('.npz'):
                    with np.load(path) as f:
                        out[key] = {k: f[k] for k in f.files}
                else:
                    with open(path, 'rb') as f:
                        out[key] = f.read()
    return out


def test_execute_is_execute_run_on_each_run(config, params, tmp_path):
    whole = _pipeline(config, params, tmp_path / 'whole', [0.0, 1.0])
    whole.execute(plot=False, verbose=False)
    by_run = _pipeline(config, params, tmp_path / 'by_run', [0.0, 1.0])
    for idx in range(len(by_run.runs)):
        by_run.execute_run(idx, plot=False)
    got, want = _products(by_run), _products(whole)
    assert sorted(got) == sorted(want) and len(got) >= 2 * 12
    for key, value in want.items():
        if isinstance(value, dict):
            assert sorted(got[key]) == sorted(value)
            for k in value:
                np.testing.assert_array_equal(got[key][k], value[k])
        else:
            assert got[key] == value, key
    assert all(r.completed for r in whole.runs + by_run.runs)
