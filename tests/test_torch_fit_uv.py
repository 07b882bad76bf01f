"""The port's visibility-space fitting against ``rajepy_tpu.fit`` on the
CPU, on the JAX fit tests' 16^3 jet: the visibility forward (coplanar and
w-stacked, with and without the primary beam) to 1e-9 with its gradient
to 1e-8, 20-step ``fit_visibilities`` and 10-step ``fit_closures`` loss
histories and final theta to 1e-9, ``closure_uncertainties`` to 1e-8,
``fit_uvfits`` from a file the port's UVFITS writer wrote, and the JAX
module's refusals (a freed distance, the closure layout, too few
antennas)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rajepy_tpu import fit as jfit
from rajepy_tpu_torch import fit as tfit
from rajepy_tpu_torch.synthobs import uvfits as tuvfits
from tests.test_torch_fit import (base_params, jit_forwards, model_pair, np_,
                                  port_grad, rel_err)
from tests.torch_one_thread import one_thread  # noqa: F401

FREQS = np.array([1e11, 3e11])
FREE = ('properties.mlr_bj', 'properties.T_0')
N_ANT, N_T = 5, 3


@pytest.fixture(scope='module')
def models():
    return model_pair(base_params(), 0.0)


@pytest.fixture(scope='module')
def layout():
    """N_T time samples of the full N_ANT-antenna pair set, time-major,
    and (u, v, w) [m] reaching the 16^3 grid's resolved scales."""
    rng = np.random.default_rng(3)
    n_bl = N_ANT * (N_ANT - 1) // 2
    uvw = rng.normal(0.0, 3e3, (N_T * n_bl, 3))
    uvw[:, 2] *= 0.2
    return uvw


def _observed(models, uvw, mlr=2e-7, seed=11):
    """Noisy visibilities of the jet at mlr_bj = ``mlr`` (the JAX
    package's forward at that theta)."""
    jm_j, _ = models
    fj, th = jit_forwards(jfit.build_vis_forward)(jm_j, FREQS, uvw, FREE)
    th = np.asarray(th).copy()
    th[0] = np.log(mlr)
    vis = np.asarray(fj(th))
    rng = np.random.default_rng(seed)
    sigma = 0.01 * np.abs(vis).max()
    return vis + sigma * (rng.normal(size=vis.shape) +
                          1j * rng.normal(size=vis.shape)), sigma


@pytest.mark.parametrize('w_planes,apply_pb', [(0, False), (2, True)])
def test_vis_forward_and_gradient_match_jax(models, layout, w_planes,
                                            apply_pb):
    jm_j, jm_t = models
    kw = dict(apply_pb=apply_pb, dish_diameter_m=2.0e3, w_planes=w_planes)
    fj, th_j = jit_forwards(jfit.build_vis_forward)(jm_j, FREQS, layout,
                                                   FREE, **kw)
    ft, th_t = tfit.build_vis_forward(jm_t, FREQS, layout, FREE, **kw)
    np.testing.assert_allclose(np_(th_t), np.asarray(th_j), rtol=1e-15)
    th = np.asarray(th_j) + np.array([0.3, -0.2])
    v_t = np_(ft(th))
    assert v_t.shape == (2, layout.shape[0]) and np.iscomplexobj(v_t)
    assert rel_err(v_t, np.asarray(fj(th))) < 1e-9
    g_j = np.asarray(jax.jit(jax.grad(
        lambda t: jnp.sum(jnp.abs(fj(t)) ** 2)))(th))
    g_t = port_grad(lambda t: torch.sum(torch.abs(ft(t)) ** 2), th)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-8)


def test_short_fit_visibilities_matches_jax(models, layout):
    jm_j, jm_t = models
    vis, sigma = _observed(models, layout)
    kw = dict(sigma=sigma, free=FREE, steps=20, learning_rate=0.05)
    res_j = jfit.fit_visibilities(jm_j, FREQS, layout, vis, **kw)
    res_t = tfit.fit_visibilities(jm_t, FREQS, layout, vis, **kw)
    np.testing.assert_allclose(res_t.loss, np.asarray(res_j.loss),
                               rtol=1e-9)
    np.testing.assert_allclose(res_t.theta, np.asarray(res_j.theta),
                               rtol=1e-9)
    assert res_t.loss[-1] < res_t.loss[0]
    assert rel_err(res_t.model, np.asarray(res_j.model)) < 1e-9


def test_fit_uvfits_from_the_ports_writer(models, layout, tmp_path):
    # a UVFITS file written by the port's writer (the one behind
    # export_uvfits), fitted by both packages with the file's weights
    jm_j, jm_t = models
    vis, sigma = _observed(models, layout)
    n_bl = N_ANT * (N_ANT - 1) // 2
    i, j = np.triu_indices(N_ANT, k=1)
    rng = np.random.default_rng(4)
    fn = tuvfits.write_uvfits(
        str(tmp_path / 'obs.uvfits'), layout, vis.real, vis.imag, FREQS,
        rng.normal(0, 1e4, (N_ANT, 3)), np.tile(i, N_T), np.tile(j, N_T),
        np.repeat(np.arange(N_T) * 30.0, n_bl), ra_deg=100.0, dec_deg=20.0,
        sigma=sigma)
    kw = dict(free=('properties.mlr_bj',), steps=10, learning_rate=0.05)
    res_j = jfit.fit_uvfits(jm_j, fn, **kw)
    res_t = tfit.fit_uvfits(jm_t, fn, **kw)
    np.testing.assert_allclose(res_t.loss, np.asarray(res_j.loss),
                               rtol=1e-9)
    np.testing.assert_allclose(res_t.theta, np.asarray(res_j.theta),
                               rtol=1e-9)
    # the file's weights are 1/sigma^2 (float32 in the file): the first
    # loss is the chi-squared of the start against the noisy data
    d = tuvfits.read_uvfits(fn)
    np.testing.assert_allclose(d['weights'], sigma ** -2.0, rtol=1e-6)


def test_short_fit_closures_matches_jax(models, layout, monkeypatch):
    jm_j, jm_t = models
    vis, _ = _observed(models, layout)
    # antenna-based gains: the closures do not see them
    rng = np.random.default_rng(2)
    g = np.exp(rng.normal(0, 0.1, (N_T, N_ANT)) +
               1j * rng.normal(0, 0.5, (N_T, N_ANT)))
    i, j = np.triu_indices(N_ANT, k=1)
    vis = vis * (g[:, i] * np.conj(g[:, j])).reshape(-1)
    kw = dict(n_ant=N_ANT, n_t=N_T, free=FREE, steps=10,
              learning_rate=0.05)
    res_j = jfit.fit_closures(jm_j, FREQS, layout, vis, **kw)
    res_t = tfit.fit_closures(jm_t, FREQS, layout, vis, **kw)
    np.testing.assert_allclose(res_t.loss, np.asarray(res_j.loss),
                               rtol=1e-9)
    np.testing.assert_allclose(res_t.theta, np.asarray(res_j.theta),
                               rtol=1e-9)
    # the JAX package's closure_uncertainties on a jitted forward
    monkeypatch.setattr(jfit, 'build_vis_forward',
                        jit_forwards(jfit.build_vis_forward))
    sig_j, cov_j = jfit.closure_uncertainties(
        jm_j, FREQS, layout, vis, res_j.theta, FREE, n_ant=N_ANT, n_t=N_T)
    sig_t, cov_t = tfit.closure_uncertainties(
        jm_t, FREQS, layout, vis, res_t.theta, FREE, n_ant=N_ANT, n_t=N_T)
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-8)
    for p in FREE:
        assert sig_t[p] == pytest.approx(sig_j[p], rel=1e-8)
    # theta as a tensor gives the same bits
    sig_tt, cov_tt = tfit.closure_uncertainties(
        jm_t, FREQS, layout, vis, torch.as_tensor(res_t.theta), FREE,
        n_ant=N_ANT, n_t=N_T)
    assert sig_tt == sig_t and np.array_equal(cov_tt, cov_t)


def test_refusals_match_jax(models, layout):
    vis = np.ones((1, layout.shape[0]), complex)
    for fit, jm in zip((jfit, tfit), models):
        with pytest.raises(ValueError, match="pixel scale"):
            fit.build_vis_forward(jm, np.array([1e11]), np.zeros((4, 3)),
                                  ('target.dist',))
        with pytest.raises(ValueError, match="time-major"):
            fit.fit_closures(jm, np.array([1e11]), layout, vis,
                             n_ant=N_ANT, n_t=N_T + 1, steps=1)
        with pytest.raises(ValueError, match="n_ant >= 4"):
            fit.closure_uncertainties(jm, np.array([1e11]), layout, vis,
                                      np.zeros(1), ('properties.mlr_bj',),
                                      n_ant=3, n_t=N_T)
        with pytest.raises(ValueError, match="n_ant >= 3"):
            fit.fit_closures(jm, np.array([1e11]), layout, vis, n_ant=2,
                             n_t=N_T, use_log_amps=False, steps=1)
        with pytest.raises(ValueError, match="at least one"):
            fit.fit_closures(jm, np.array([1e11]), layout, vis,
                             n_ant=N_ANT, n_t=N_T, use_phases=False,
                             use_log_amps=False, steps=1)
