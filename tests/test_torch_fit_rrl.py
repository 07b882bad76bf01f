"""The port's RRL, non-LTE, joint, light-curve and sweep fitting against
``rajepy_tpu.fit`` on the CPU, on the JAX fit tests' 16^3 jet (H58a, five
channels across the line).

* the RRL forwards (maps and spectrum, LTE and non-LTE, with and without
  the continuum) to 1e-6 (the JAX package's RRL contract) and ``theta0``
  to 1e-15; the gradient of a spectrum loss in T_0, v_lsr, mlr_bj and the
  two ``nonlte.*`` pseudo-paths against ``jax.grad`` to 1e-8;
* 10-step ``fit_rrl_spectrum`` and ``fit_joint`` loss histories and final
  theta to 1e-9; ``rrl_departure_systematic`` to 1e-6;
* the light curve's forward to 1e-9, its gradient to 1e-8 and a 20-step
  ``fit_light_curve`` to 1e-9;
* ``sweep`` against the pointwise forwards to 1e-12 (product, zip,
  chunked, and the non-LTE RRL spectrum) and a map sweep against the JAX
  package's to 1e-9;
* the refusals of the JAX module.
"""
import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rajepy_tpu import fit as jfit
from rajepy_tpu.ops import rrls as jrrls
from rajepy_tpu_torch import fit as tfit
from tests.test_torch_fit import (SED_FREQS, YEAR, base_params,
                                  jit_forwards, model_pair, np_, port_grad,
                                  rel_err)
from tests.torch_one_thread import one_thread  # noqa: F401

LINE = 'H58a'
NU0 = jrrls.rrl_nu_0('H', 58, 1)
FREQS = NU0 * (1.0 + np.linspace(-3e-4, 3e-4, 5))
RRL_RTOL = 1e-6


def same_theta0(got, want):
    """theta0 to 1e-15: relative for the log/linear values, and 1e-15
    absolute for log(b_n) ~ -1e-3, where it is 1e-15 of the value b_n (the
    two packages' departure tables round b_n's last bit apart)."""
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-15,
                               atol=1e-15)


@pytest.fixture(scope='module')
def models():
    return model_pair(base_params(), 2.0)


def test_rrl_forwards_match_jax(models):
    jm_j, jm_t = models
    free = ('properties.T_0', 'target.v_lsr')
    th = np.array([np.log(8e3), 12.0])
    # maps, line + continuum, LTE
    fj, th_j = jfit.build_rrl_forward(jm_j, LINE, FREQS, free,
                                      contsub=False)
    ft, th_t = tfit.build_rrl_forward(jm_t, LINE, FREQS, free,
                                      contsub=False)
    same_theta0(th_t, th_j)
    maps = np_(ft(th))
    assert maps.shape == (5, 16, 16)
    assert rel_err(maps, np.asarray(jax.jit(fj)(th))) < RRL_RTOL
    # the forward at theta0 is the port's own flux_rrl
    assert rel_err(np_(ft(th_t)), np.nan_to_num(jm_t.flux_rrl(
        LINE, FREQS, contsub=False))) < 1e-12
    # spectrum, line only, non-LTE with table coefficients
    sj, th_j = jfit.build_rrl_spectrum_forward(jm_j, LINE, FREQS, free,
                                               lte=False)
    st, th_t = tfit.build_rrl_spectrum_forward(jm_t, LINE, FREQS, free,
                                               lte=False)
    same_theta0(th_t, th_j)
    assert rel_err(np_(st(th)), np.asarray(jax.jit(sj)(th))) < RRL_RTOL


def test_rrl_gradients_match_jax(models):
    # the Voigt profile's derivative (the wofz Function) and the non-LTE
    # pseudo-paths, through one spectrum loss
    jm_j, jm_t = models
    free = ('properties.T_0', 'target.v_lsr', 'properties.mlr_bj',
            'nonlte.b_n1', 'nonlte.b_n2')
    fj, th_j = jfit.build_rrl_spectrum_forward(jm_j, LINE, FREQS, free)
    ft, th_t = tfit.build_rrl_spectrum_forward(jm_t, LINE, FREQS, free)
    same_theta0(th_t, th_j)
    w = np.array([1.0, -2.0, 3.0, 0.5, -1.0]) * 1e6
    v_j, g_j = jax.jit(jax.value_and_grad(
        lambda t: jnp.sum(w * fj(t)) ** 2))(th_j)
    g_t = port_grad(lambda t: torch.sum(torch.as_tensor(w) * ft(t)) ** 2,
                    th_j)
    assert np.all(g_t != 0)
    np.testing.assert_allclose(g_t, np.asarray(g_j), rtol=1e-8)


def test_short_fit_rrl_spectrum_matches_jax(models):
    jm_j, jm_t = models
    ft, th = tfit.build_rrl_spectrum_forward(
        jm_t, LINE, FREQS, ('properties.T_0', 'target.v_lsr'))
    obs = np_(ft(np_(th) + np.array([-0.3, 8.0])))
    kw = dict(steps=10, learning_rate=0.05)
    res_j = jfit.fit_rrl_spectrum(jm_j, LINE, FREQS, obs, **kw)
    res_t = tfit.fit_rrl_spectrum(jm_t, LINE, FREQS, obs, **kw)
    np.testing.assert_allclose(res_t.loss, np.asarray(res_j.loss),
                               rtol=1e-9)
    np.testing.assert_allclose(res_t.theta, np.asarray(res_j.theta),
                               rtol=1e-9)
    assert res_t.loss[-1] < res_t.loss[0]


def test_departure_systematic_matches_jax(models, monkeypatch):
    jm_j, jm_t = models
    # the JAX package's rrl_departure_systematic on jitted forwards
    monkeypatch.setattr(jfit, 'build_rrl_spectrum_forward',
                        jit_forwards(jfit.build_rrl_spectrum_forward))
    free = ('properties.T_0', 'target.v_lsr')
    th = np.array([np.log(1e4), 6.2])
    s_j = jfit.rrl_departure_systematic(jm_j, LINE, FREQS[1:3], th, free)
    s_t = tfit.rrl_departure_systematic(jm_t, LINE, FREQS[1:3], th, free)
    for p in free:
        assert s_t[p] > 0
        assert s_t[p] == pytest.approx(s_j[p], rel=RRL_RTOL)
    # theta as a tensor gives the same bits
    assert tfit.rrl_departure_systematic(jm_t, LINE, FREQS[1:3],
                                         torch.as_tensor(th), free) == s_t


def test_short_fit_joint_matches_jax(models):
    # an SED at one epoch, a non-LTE profile at another: the nonlte slot
    # comes from the RRL component, the SED ignores it
    jm_j, jm_t = models
    free = ('properties.mlr_bj', 'properties.T_0', 'nonlte.b_n2')
    fs, th = tfit.build_sed_forward(jm_t, SED_FREQS, free[:2])
    sed = np_(fs(np_(th) + np.array([0.4, -0.2])))
    fr, th = tfit.build_rrl_spectrum_forward(jm_t, LINE, FREQS, free,
                                             time=1.0 * YEAR)
    prof = np_(fr(np_(th) + np.array([0.4, -0.2, 0.01])))
    comps = [{'kind': 'sed', 'freqs': SED_FREQS, 'observed': sed},
             {'kind': 'rrl_spectrum', 'line': LINE, 'freqs': FREQS,
              'observed': prof, 'weight': 2.0, 'time': 1.0 * YEAR}]
    kw = dict(free=free, steps=10, learning_rate=0.05)
    res_j = jfit.fit_joint(jm_j, comps, **kw)
    res_t = tfit.fit_joint(jm_t, comps, **kw)
    np.testing.assert_allclose(res_t.loss, np.asarray(res_j.loss),
                               rtol=1e-9)
    np.testing.assert_allclose(res_t.theta, np.asarray(res_j.theta),
                               rtol=1e-9)
    assert len(res_t.model) == 2
    assert rel_err(res_t.model[1], np.asarray(res_j.model[1])) < RRL_RTOL


@pytest.fixture(scope='module')
def light_curve():
    times = np.linspace(0.3, 2.0, 6) * YEAR
    freqs = np.array([4.4e10, 1e11])
    jm_j, jm_t = model_pair(base_params(), 0.0)
    fj, th_j, _ = jfit.build_light_curve_forward(jm_j, times, freqs)
    ft, th_t, _ = tfit.build_light_curve_forward(jm_t, times, freqs)
    return dict(times=times, freqs=freqs, jm_j=jm_j, jm_t=jm_t, fj=fj,
                ft=ft, th_j=np.asarray(th_j), th_t=np_(th_t))


def test_light_curve_forward_and_gradient_match_jax(light_curve):
    lc = light_curve
    same_theta0(lc['th_t'], lc['th_j'])
    th = lc['th_j'] + np.linspace(-0.1, 0.1, lc['th_j'].size)
    curve = np_(lc['ft'](th))
    assert curve.shape == (6, 2)
    assert rel_err(curve, np.asarray(jax.jit(lc['fj'])(th))) < 1e-9
    g_j = np.asarray(jax.jit(jax.grad(
        lambda t: jnp.sum(jnp.log(lc['fj'](t)))))(th))
    g_t = port_grad(lambda t: torch.sum(torch.log(lc['ft'](t))), th)
    assert np.all(np.isfinite(g_t)) and np.any(g_t != 0)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-8, atol=1e-12 *
                               np.abs(g_j).max())


def test_short_fit_light_curve_matches_jax(light_curve):
    lc = light_curve
    th = lc['th_j'] + np.linspace(-0.1, 0.1, lc['th_j'].size)
    obs = np_(lc['ft'](th))
    kw = dict(steps=20, learning_rate=0.03)
    res_j = jfit.fit_light_curve(lc['jm_j'], lc['times'], lc['freqs'], obs,
                                 **kw)
    res_t = tfit.fit_light_curve(lc['jm_t'], lc['times'], lc['freqs'], obs,
                                 **kw)
    np.testing.assert_allclose(res_t.loss, np.asarray(res_j.loss),
                               rtol=1e-9)
    for k in ('t_0', 'hl', 'chi'):
        np.testing.assert_allclose(getattr(res_t, k), getattr(res_j, k),
                                   rtol=1e-9)
    assert rel_err(res_t.model, res_j.model) < 1e-9
    assert res_t.loss[-1] < res_t.loss[0]


@pytest.mark.parametrize('product,batch_size', [(True, None), (False, None),
                                                (True, 2)])
def test_sweep_equals_pointwise_forwards(models, product, batch_size):
    _, jm_t = models
    grid = {'properties.mlr_bj': [1e-7, 2e-7, 4e-7],
            'geometry.inc': [60.0, 75.0, 90.0]}
    res = tfit.sweep(jm_t, SED_FREQS, grid, product=product,
                     batch_size=batch_size)
    n = 9 if product else 3
    assert res.values.shape == (n, 4)
    ft, _ = tfit.build_sed_forward(jm_t, SED_FREQS, tuple(grid))
    for k in range(n):
        th = [np.log(res.points['properties.mlr_bj'][k]),
              res.points['geometry.inc'][k]]
        np.testing.assert_allclose(res.values[k], np_(ft(th)), rtol=1e-12)
    if product:
        assert res.reshaped().shape == (3, 3, 4)


def test_sweep_matches_jax(models):
    jm_j, jm_t = models
    # the non-LTE pseudo-path through the RRL spectrum: the pointwise
    # forwards (held against JAX in test_rrl_gradients_match_jax)
    grid = {'properties.T_0': [6e3, 1.2e4], 'nonlte.b_n2': [0.9, 1.1]}
    res_t = tfit.sweep(jm_t, FREQS, grid, kind='rrl_spectrum', line=LINE,
                       product=False)
    ft, _ = tfit.build_rrl_spectrum_forward(jm_t, LINE, FREQS, tuple(grid))
    for k in range(2):
        th = np.log([res_t.points[p][k] for p in grid])
        np.testing.assert_allclose(res_t.values[k], np_(ft(th)),
                                   rtol=1e-12)
    grid = {'properties.mlr_bj': [1e-7, 3e-7]}
    res_j = jfit.sweep(jm_j, np.array([1e11]), grid, kind='map')
    res_t = tfit.sweep(jm_t, np.array([1e11]), grid, kind='map')
    assert res_t.values.shape == (2, 1, 16, 16)
    assert rel_err(res_t.values, np.asarray(res_j.values)) < 1e-9


def test_refusals_match_jax(models, light_curve):
    p = base_params()
    p['ejection'] = {'t_0': np.array([]), 'hl': np.array([]),
                     'chi': np.array([]), 'which': np.array([])}
    for fit, jm in zip((jfit, tfit), models):
        sed = {'kind': 'sed', 'freqs': SED_FREQS, 'observed': np.ones(4)}
        with pytest.raises(ValueError, match="unknown joint-fit"):
            fit.fit_joint(jm, [{'kind': 'spectrum'}], steps=1)
        with pytest.raises(ValueError, match="at least one component"):
            fit.fit_joint(jm, [], steps=1)
        with pytest.raises(ValueError, match="rrl_spectrum/rrl_cube"):
            fit.fit_joint(jm, [sed], free=('nonlte.b_n2',), steps=1)
        with pytest.raises(ValueError, match="only meaningful in the RRL"):
            fit.fit_sed(jm, SED_FREQS, np.ones(4), free=('nonlte.b_n1',),
                        steps=1)
        with pytest.raises(ValueError, match="was a FREE parameter"):
            fit.rrl_departure_systematic(jm, LINE, FREQS, np.zeros(1),
                                         ('nonlte.b_n2',))
        with pytest.raises(ValueError, match="sightline"):
            fit.build_rrl_forward(jm, LINE, FREQS, ('properties.T_0',),
                                  lte=False, departure_coeffs=(
                                      np.ones((3, 3)), 1.0))
        with pytest.raises(ValueError, match="SCALAR"):
            fit.build_rrl_forward(jm, LINE, FREQS, ('nonlte.b_n1',),
                                  departure_coeffs=(np.ones((16, 16)), 1.0))
        with pytest.raises(ValueError, match="free must be among"):
            fit.build_light_curve_forward(jm, [0.0], SED_FREQS, ('amp',))
        with pytest.raises(ValueError, match="needs line="):
            fit.sweep(jm, FREQS, {'properties.T_0': [1e4]},
                      kind='rrl_spectrum')
        with pytest.raises(ValueError, match="unknown sweep kind"):
            fit.sweep(jm, FREQS, {'properties.T_0': [1e4]}, kind='cube')
        with pytest.raises(ValueError, match="equal-length"):
            fit.sweep(jm, FREQS, {'properties.T_0': [1e4, 2e4],
                                  'properties.x_0': [0.1]}, product=False)
        with pytest.raises(ValueError, match="only meaningful in the RRL"):
            fit.sweep(jm, FREQS, {'nonlte.b_n2': [1.0]})
    jm_t = type(models[1])(copy.deepcopy(p), device='cpu')
    with pytest.raises(ValueError, match="no ejection events"):
        tfit.build_light_curve_forward(jm_t, [0.0], SED_FREQS)
