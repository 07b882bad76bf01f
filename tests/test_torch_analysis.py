"""The port's ``models.analysis`` against the JAX package's, on the CPU.

* float64, the JAX analysis tests' burst-free jet (24 x 64 x 24): ``sed``,
  ``sed_spectral_indices``, ``spectral_index_map`` and ``turnover_map``
  to 1e-9 of the JAX result's largest magnitude (NaN in the same
  pixels); ``moment_maps`` of a cube of Gaussian lines made with numpy
  to 1e-9, its centroids and widths recovered;
* ``light_curve`` over five epochs across the conftest jet's two bursts
  (the epochs where a burst's material fills the grid and where it has
  left): float64 to 1e-9, and float32 (the port's plain version of the
  single-base epoch kernel against the JAX package's fused path in the
  Pallas interpreter) to 1e-5, with ``sed``, ``spectral_index_map`` and
  ``turnover_map`` of the float32 burst model at the same tolerance;
* each epoch of the port's light curve is that epoch's ``flux_ff`` summed
  over the map, and the light curve moves with the bursts.
"""
import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rajepy_tpu import JetModel as JaxJetModel
from rajepy_tpu.models import analysis as janalysis
from rajepy_tpu.ops import pallas_kernels as pk
from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch.models import analysis as tanalysis
from rajepy_tpu_torch.ops import radtrans as trt
from tests.torch_one_thread import one_thread  # noqa: F401

YEAR = 31536000.0
RTOL = {'float64': 1e-9, 'float32': 1e-5}
FREQS = np.logspace(8.5, 11.5, 13)
EPOCHS_YR = [0.3, 0.55, 0.8, 1.2, 2.0]
NO_BURSTS = {'t_0': np.array([]), 'hl': np.array([]), 'chi': np.array([]),
             'which': np.array([])}


@pytest.fixture()
def forced_interpret():
    pk.force_interpret(True)
    try:
        yield
    finally:
        pk.force_interpret(False)


def _pair(params, n, dtype='float64', bursts=True, t_yr=0.6):
    p = copy.deepcopy(params)
    p['grid'].update(n_x=n[0], n_y=n[1], n_z=n[2])
    if not bursts:
        p['ejection'] = copy.deepcopy(NO_BURSTS)
    jdt, tdt = {'float64': (jnp.float64, torch.float64),
                'float32': (jnp.float32, torch.float32)}[dtype]
    jm_j = JaxJetModel(copy.deepcopy(p), dtype=jdt)
    jm_t = JetModel(copy.deepcopy(p), dtype=tdt, device='cpu')
    jm_j.time = jm_t.time = t_yr * YEAR
    return jm_j, jm_t


def _rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    scale = np.abs(want).max()
    assert scale > 0
    return np.abs(got - want).max() / scale


def _maps(analysis, jm):
    seds = analysis.sed(jm, FREQS)
    fmid, alphas = analysis.sed_spectral_indices(FREQS, seds)
    return {'sed': seds, 'fmid': fmid, 'alphas': alphas,
            'spectral_index_map': analysis.spectral_index_map(
                jm, 1e9, 2e9, min_flux_jy=1e-12),
            'turnover_map': analysis.turnover_map(
                jm, np.logspace(8.5, 11.5, 25))}


def _check_maps(got, want, rtol):
    for name in want:
        err = _rel(got[name], want[name])
        assert err < rtol, f"{name}: rel err {err:.2e}"


def test_sed_and_maps_match_jax_f64(model_params):
    jm_j, jm_t = _pair(model_params, (24, 64, 24), bursts=False)
    got, want = _maps(tanalysis, jm_t), _maps(janalysis, jm_j)
    _check_maps(got, want, RTOL['float64'])
    # the JAX analysis tests' physics on the port's products
    alphas = got['alphas']
    assert np.all(got['sed'] > 0) and alphas[0] > 0.5 and alphas[-1] < 0.3
    finite = got['turnover_map'][np.isfinite(got['turnover_map'])]
    assert finite.size and np.all((finite >= 10 ** 8.5) &
                                  (finite <= 10 ** 11.5))


def test_moment_maps_match_jax():
    """A cube of Gaussian lines made with numpy from a seed, each pixel's
    centroid and width known: the same moments as the JAX package's, and
    the centroids and widths recovered."""
    nu0 = trt.RRLCoeffs('H58a').nu0
    chans = np.linspace(nu0 - 4e6, nu0 + 4e6, 41)
    v = 299792.458 * (1.0 - chans / nu0)
    rng = np.random.default_rng(7)
    v_c = rng.uniform(-10.0, 10.0, (12, 9))
    sig = rng.uniform(4.0, 8.0, (12, 9))
    amp = rng.uniform(0.5, 2.0, (12, 9))
    amp[0, :] = 0.0                            # empty pixels: NaN moments
    cube = amp * np.exp(-0.5 * ((v[:, None, None] - v_c) / sig) ** 2)
    got = tanalysis.moment_maps(cube, chans, nu0)
    want = janalysis.moment_maps(cube, chans, nu0)
    assert set(got) == set(want) == {'mom0', 'mom1', 'mom2'}
    for name in want:
        assert _rel(got[name], want[name]) < RTOL['float64'], name
    assert np.all(np.isnan(got['mom1'][0])) and np.all(got['mom0'][0] == 0)
    np.testing.assert_allclose(got['mom1'][1:], v_c[1:], atol=0.05)
    np.testing.assert_allclose(got['mom2'][1:], sig[1:], rtol=0.02)
    with pytest.raises(ValueError, match='2 channels'):
        tanalysis.moment_maps(cube[:1], chans[:1], nu0)


@pytest.mark.parametrize("dtype", ['float64', 'float32'])
def test_light_curve_across_bursts_matches_jax(forced_interpret,
                                               model_params, dtype):
    jm_j, jm_t = _pair(model_params, (24, 48, 24), dtype)
    freqs = FREQS[::4]
    got = tanalysis.light_curve(jm_t, EPOCHS_YR, freqs)
    want = janalysis.light_curve(jm_j, EPOCHS_YR, freqs)
    assert got.shape == (len(EPOCHS_YR), len(freqs))
    err = _rel(got, want)
    assert err < RTOL[dtype], f"light_curve: rel err {err:.2e}"
    # the bursts move the optically thin flux, and each epoch is flux_ff's
    # sum
    assert np.ptp(got[:, -1]) > 0.1 * np.abs(got[:, -1]).max()
    for k, t_yr in enumerate(EPOCHS_YR):
        jm_t.time = t_yr * YEAR
        np.testing.assert_allclose(
            got[k], jm_t.flux_ff(freqs).sum(axis=(1, 2)),
            rtol=RTOL[dtype])
    if dtype == 'float32':
        assert jm_t._use_tiles() and jm_t._rt_static().seg is not None
        jm_j.time = jm_t.time = EPOCHS_YR[1] * YEAR
        _check_maps(_maps(tanalysis, jm_t), _maps(janalysis, jm_j),
                    RTOL[dtype])
