"""An observed line-cube run of the port, reached through
``Pipeline.execute_run``, held stage by stage against the plain reference
of the cube chain (``benchmark/reference/observe_cube.py``, float64) on
the CPU, as the benchmark's cell ``example_jet_512.h58a_observe`` holds it:

* the cell's configuration on 48^3 cells, H58a cut to 8 channels of 0.1
  MHz about the line, 4 time samples a scan, niter 50 (the image keeps the
  program's floor of 500 pixels, so one thread CLEANs a channel in ~1
  s): the flux cube, and on every channel the clean visibilities, the
  noise, the dirty image, the centre channel's PSF, Hogbom's model and
  residual and the restored image, each from the run's own inputs to it;
* ``clean_cube`` asked for its model and residual gives them on the host,
  the restored and dirty cubes unchanged bit for bit, and each restored
  channel is its model convolved with the common beam plus its residual,
  bit for bit.
"""
import copy
import importlib
import json
import os

import numpy as np
import pytest
import torch

from rajepy_tpu_torch import JetModel, Pipeline
from rajepy_tpu_torch.synthobs import imaging
from tests.torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = 'example_jet_512_vla_a_h58a'
N_CHAN = 8
SYNTHOBS = {'save_products': ['psf', 'dirty', 'model', 'residual'],
            'max_time_samples': 4, 'niter': 50}
kind = importlib.import_module('benchmark.kinds.observe_cube_runs')

#: the largest gap each stage may show, and why
TOLERANCES = {
    # float64 on both sides: the jet's line and continuum the same sums
    'flux_gap': 1e-12,
    # the program degrids an FFT of the sky with a Kaiser-Bessel kernel of
    # 6 cells; the reference is the exact transform
    'vis_gap': 1e-5,
    # the noise's rms against sigma, in standard errors of an rms
    'noise_gap': 5.0,
    # the same sums (gridding, FFT, Hogbom's updates, the restoring
    # convolution) in float64, in another order or by another method
    'dirty_gap': 1e-12, 'psf_gap': 1e-12, 'clean_gap': 1e-12,
    'restored_gap': 1e-12,
}


def _json(*path):
    with open(os.path.join(ROOT, 'benchmark', *path)) as f:
        return json.load(f)


MIX = dict(_json('traffic', 'h58a_observe.json'), synthobs=SYNTHOBS)


@pytest.fixture(scope='module')
def config():
    """The cell's configuration on 48^3 cells, N_CHAN channels."""
    c = _json('configs', CONFIG + '.json')
    c['grid'].update(n_x=48, n_y=48, n_z=48)
    rrls = c['pipeline']['rrls']
    rrls['bws'] = [N_CHAN * rrls['chanws'][0]]
    return c


@pytest.fixture(scope='module')
def gaps(config, tmp_path_factory):
    """The gaps of the observed run on every channel."""
    from benchmark.harness.workloads import model_params
    pl = Pipeline(JetModel(copy.deepcopy(model_params(config)),
                           device='cpu'),
                  kind.campaign(config, MIX,
                                str(tmp_path_factory.mktemp('cube'))))
    pl.execute_run(0, plot=False, resume=False, clobber=True)
    run = pl.runs[0]
    assert run.completed and len(run.chan_freqs) == N_CHAN
    files = {k: os.path.relpath(v, run.rt_dcy)
             for k, v in run.products.items() if k in kind.PRODUCTS}
    files['flux'] = os.path.basename(run.fits_flux)
    assert sorted(files) == sorted(kind.PRODUCTS + ('flux',))
    got = kind.read_products(run.rt_dcy, files, list(range(N_CHAN)))
    w = kind.Workload(config, MIX, 5, 'cpu')
    np.testing.assert_allclose(w.setup_ref['chan_freqs'], run.chan_freqs,
                               rtol=1e-12, atol=0)
    return kind.compare(got, w.flux(), w.setup_ref, 'cpu')


@pytest.mark.parametrize('check', sorted(TOLERANCES))
def test_observed_cube_meets_the_reference(gaps, check):
    assert set(gaps) == set(TOLERANCES)
    assert gaps[check] <= TOLERANCES[check], (check, gaps[check])


def _cube_inputs():
    """A 6-antenna, 3-channel cube of two points on a 64^2 image."""
    rng = np.random.default_rng(3)
    ant = rng.uniform(-400.0, 400.0, (6, 3))
    i, j = np.triu_indices(6, 1)
    uvw = np.concatenate([ant[j] - ant[i] + rng.normal(0.0, 5.0, (15, 3))
                          for _ in range(20)])
    freqs = np.array([1.00e9, 1.01e9, 1.02e9])
    lam = 299792458.0 / freqs
    cell = 2e-4
    vis = np.stack([
        1.0 * np.exp(-2j * np.pi * (uvw[:, 0] * 5 * cell) / la) +
        0.5 * np.exp(-2j * np.pi * (-uvw[:, 1] * 3 * cell) / la)
        for la in lam]) + rng.normal(0.0, 0.05, (3, len(uvw)))
    n = 64
    mask = np.zeros((n, n))
    mask[20:44, 20:44] = 1.0
    kern = imaging.gaussian_beam_kernel(n, cell, 4 * cell, 3 * cell, 30.0)
    return (uvw, freqs, torch.from_numpy(vis), np.ones(len(uvw)), n, cell,
            mask, kern)


def test_clean_cube_model_and_residual_restore_to_the_cube():
    args = _cube_inputs()
    restored, dirty = imaging.clean_cube(*args, niter=40, chan_block=2)
    r2, d2, model, res = imaging.clean_cube(*args, niter=40, chan_block=2,
                                            model_residual=True)
    assert torch.equal(r2, restored) and torch.equal(d2, dirty)
    assert model.device.type == 'cpu' and res.device.type == 'cpu'
    assert model.shape == res.shape == restored.shape
    assert int(torch.count_nonzero(model)) > 0
    n = args[4]
    fkern = torch.fft.rfft2(torch.fft.ifftshift(torch.as_tensor(args[-1])))
    for k in range(len(args[1])):
        again = torch.fft.irfft2(torch.fft.rfft2(model[k]) * fkern,
                                 s=(n, n)) + res[k]
        assert torch.equal(again, restored[k]), k
