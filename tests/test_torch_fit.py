"""The port's ``fit`` (parameters, continuum forwards, gradients, the
driver and the uncertainties) against the JAX package's ``rajepy_tpu.fit``
on the CPU, on the JAX fit tests' 16^3 jet.

* ``theta0`` to 1e-15, the float64 flux and SED forwards to 1e-9;
* the autograd gradient against ``jax.grad`` of the same loss to 1e-8
  relative for every ``SUPPORTED_FREE`` path freed on its own (the
  ``nonlte.*`` paths through the RRL forward, in test_torch_fit_rrl.py):
  a ``math.*`` call that drops a tensor's gradient shows here;
* the float32 forward and gradient against float64 (1e-5, 1e-4);
* ``wofz``'s derivative (an autograd Function on the Faddeeva ODE)
  against finite differences, in reverse and forward mode;
* 20-step ``fit_sed``/``fit_map`` loss histories and final theta to 1e-9,
  Adam against optax.adam and a caller's optimizer against optax.sgd;
* ``laplace_uncertainties`` sigma and covariance to 1e-8;
* the randomised parts by their statistics: ``n_starts`` (chain 0 is the
  single start, the best chain no worse), ``sample_posterior`` (the JAX
  fit test's criteria, from the JAX fit's optimum and covariance);
* the refusals: unsupported paths, a derivative through the 2F1 series.
"""
import copy

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from rajepy_tpu import JetModel as JaxJetModel
from rajepy_tpu import fit as jfit
from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch import fit as tfit
from rajepy_tpu_torch.ops import voigt as tvoigt
from tests.torch_one_thread import one_thread  # noqa: F401

YEAR = 31536000.0
SED_FREQS = np.array([6e9, 4.4e10, 1e11, 3e11])
NO_BURSTS = {'t_0': np.array([]), 'hl': np.array([]), 'chi': np.array([]),
             'which': np.array([])}
REAL_FREE = tuple(p for p in tfit.SUPPORTED_FREE
                  if not p.startswith('nonlte.'))


def base_params(n=16):
    """The conftest jet (the bundled example's values) on an n^3 grid."""
    return {
        "target": {"name": "test", "ra": "04:31:34.07736",
                   "dec": "+18:08:04.9020", "epoch": "J2000", "dist": 120.,
                   "v_lsr": 6.2, "M_star": 0.55, "R_1": .25, "R_2": 2.5},
        "grid": {"n_x": n, "n_y": n, "n_z": n, "l_z": None,
                 "c_size": 0.5},
        "geometry": {"epsilon": 7. / 9., "opang": 25., "w_0": 1.,
                     "r_0": 1., "inc": 90., "pa": 0., "rotation": "CCW"},
        "power_laws": {"q_v": 0., "q_T": 0., "q_x": 0., "q^d_n": 0.,
                       "q^d_T": 0., "q^d_v": 0., "q^d_x": 0.},
        "properties": {"v_0": 150., "x_0": 0.1, "T_0": 1E4, "mu": 1.3,
                       "mlr_bj": 1e-7, "mlr_rj": 5e-8},
        "ejection": {"t_0": np.array([0.5, 0.75]),
                     "hl": np.array([0.15, 0.15]),
                     "chi": np.array([5., 2.5]),
                     "which": np.array(["R", "B"])},
    }


def model_pair(params, t_yr=2.0):
    """The same jet in both packages (the port's on the CPU), float64."""
    jm_j = JaxJetModel(copy.deepcopy(params))
    jm_t = JetModel(copy.deepcopy(params), device='cpu')
    jm_j.time = jm_t.time = t_yr * YEAR
    return jm_j, jm_t


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / (scale if scale else 1.0))


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def port_grad(loss, theta):
    th = torch.as_tensor(np_(theta)).requires_grad_(True)
    val = loss(th)
    return np_(torch.autograd.grad(val, th, allow_unused=True,
                                   materialize_grads=True)[0]) \
        if val.requires_grad else np.zeros(th.shape)


def jit_forwards(build):
    """A JAX ``build_*_forward`` whose forward is ``jax.jit``-compiled: the
    JAX functions that evaluate their forwards eagerly (Jacobians of the
    uncertainties) then compile one program instead of dispatching every
    operation, which keeps these tests' time down; the numbers agree with
    the eager ones to rounding."""
    def wrapped(*args, **kwargs):
        fwd, theta0 = build(*args, **kwargs)
        return jax.jit(fwd), theta0
    return wrapped


@pytest.fixture(scope='module')
def off_axis():
    """Bursts in the grid's past (2 yr) and an off-axis geometry, whose
    voxel corners do not sit on the jet boundary."""
    p = base_params()
    p['geometry'].update(inc=60., pa=20.)
    return model_pair(p)


@pytest.fixture(scope='module')
def off_axis_no_bursts():
    """As ``off_axis`` without bursts: the JAX package has no gradient in
    epsilon or q_v on a burst model (its travel-time series needs a
    concrete c), so those paths are held here."""
    p = base_params()
    p['geometry'].update(inc=60., pa=20.)
    p['ejection'] = copy.deepcopy(NO_BURSTS)
    return model_pair(p)


def test_theta0_matches_jax_for_every_path(off_axis):
    jm_j, jm_t = off_axis
    for build in ('build_flux_forward', 'build_sed_forward'):
        _, th_j = getattr(jfit, build)(jm_j, SED_FREQS, REAL_FREE)
        _, th_t = getattr(tfit, build)(jm_t, SED_FREQS, REAL_FREE)
        assert th_t.dtype == torch.float64
        np.testing.assert_allclose(np_(th_t), np_(th_j), rtol=1e-15,
                                   atol=0)


def test_flux_and_sed_forwards_match_jax():
    # at 0.6 yr the bursts' material fills the grid (the 2 yr epoch of the
    # other tests is held by the short fits' first losses)
    p = base_params()
    p['geometry'].update(inc=60., pa=20.)
    jm_j, jm_t = model_pair(p, 0.6)
    free = ('properties.mlr_bj', 'properties.T_0', 'geometry.inc')
    fj, th0 = jfit.build_flux_forward(jm_j, SED_FREQS, free)
    ft, _ = tfit.build_flux_forward(jm_t, SED_FREQS, free)
    st, _ = tfit.build_sed_forward(jm_t, SED_FREQS, free)
    th = np_(th0) + np.array([0.2, -0.1, 1.5])
    maps = np_(ft(th))
    maps_j = np_(jax.jit(fj)(th))
    assert maps.shape == (4, 16, 16) and maps.dtype == np.float64
    assert rel_err(maps, maps_j) < 1e-9
    assert rel_err(np_(st(th)), maps_j.sum(axis=(1, 2))) < 1e-9
    # the port's forward replays its own flux_ff at theta0
    assert rel_err(np_(st(th0)), np.nansum(jm_t.flux_ff(SED_FREQS),
                                           axis=(1, 2))) < 1e-12


SED_WEIGHTS = np.array([1.0, -0.5, 2.0, 0.25])   # every channel counts


@pytest.fixture(scope='module')
def jax_path_grads(off_axis_no_bursts):
    """``jax.grad`` of the weighted log-SED loss with the real paths
    freed at once: entry i is the partial derivative in path i, the same
    number as with path i freed alone (two compiles instead of 14).
    ``power_laws.q_T`` goes alone: freeing it selects the Reynolds gaunt
    form for the whole forward."""
    jm_j, _ = off_axis_no_bursts
    out = {}
    for group in (tuple(p for p in REAL_FREE if p != 'power_laws.q_T'),
                  ('power_laws.q_T',)):
        fj, th = jfit.build_sed_forward(jm_j, SED_FREQS, group)
        g = jax.jit(jax.grad(lambda t: jnp.sum(SED_WEIGHTS *
                                               jnp.log(fj(t)))))(th)
        out.update(zip(group, np.asarray(g)))
    return out


@pytest.mark.parametrize('path', REAL_FREE)
def test_gradient_matches_jax_for_every_path(off_axis_no_bursts,
                                             jax_path_grads, path):
    # the port's forward with this one path freed
    _, jm_t = off_axis_no_bursts
    ft, th = tfit.build_sed_forward(jm_t, SED_FREQS, (path,))
    g_t = port_grad(lambda t: torch.sum(torch.as_tensor(SED_WEIGHTS) *
                                        torch.log(ft(t))), th)
    g_j = jax_path_grads[path]
    if path == 'target.v_lsr':        # the continuum has no velocity
        assert g_j == 0 and np.all(g_t == 0)
    else:
        assert np.all(g_t != 0)
        np.testing.assert_allclose(g_t, [g_j], rtol=1e-8, atol=0)


@pytest.mark.parametrize('path', ['properties.v_0', 'geometry.inc'])
def test_gradient_matches_jax_with_bursts(path):
    # at 0.6 yr the burst factor weighs the cells through the travel
    # times, which v_0 and inc move
    p = base_params()
    p['geometry'].update(inc=60., pa=20.)
    jm_j, jm_t = model_pair(p, 0.6)
    fj, th = jfit.build_flux_forward(jm_j, SED_FREQS, (path,))
    ft, _ = tfit.build_flux_forward(jm_t, SED_FREQS, (path,))
    g_j = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(fj(t) ** 2)))(th))
    g_t = port_grad(lambda t: torch.sum(ft(t) ** 2), th)
    assert np.all(g_t != 0)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-8, atol=0)


def test_series_derivative_refused_like_jax():
    # q^d_v != 0 on a burst model: the travel times run the 2F1 series,
    # which neither package differentiates.  The port refuses, naming the
    # freed path, and still evaluates the forward without gradients.
    p = base_params()
    p['geometry'].update(inc=60., pa=20.)
    p['power_laws']['q^d_v'] = 0.5
    jm_j, jm_t = model_pair(p, 0.6)
    fj, th = jfit.build_sed_forward(jm_j, SED_FREQS, ('geometry.inc',))
    ft, _ = tfit.build_sed_forward(jm_t, SED_FREQS, ('geometry.inc',))
    with pytest.raises(ValueError, match="lax.while_loop"):
        jax.jit(jax.grad(lambda t: jnp.sum(fj(t))))(th)
    with pytest.raises(ValueError, match="geometry.inc"):
        port_grad(lambda t: torch.sum(ft(t)), th)
    assert rel_err(np_(ft(np_(th))), np.nansum(
        jm_t.flux_ff(SED_FREQS), axis=(1, 2))) < 1e-12
    # a path that moves no series term keeps its gradient
    fj, th = jfit.build_sed_forward(jm_j, SED_FREQS, ('properties.T_0',))
    ft, _ = tfit.build_sed_forward(jm_t, SED_FREQS, ('properties.T_0',))
    np.testing.assert_allclose(
        port_grad(lambda t: torch.sum(torch.log(ft(t))), th),
        np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(jnp.log(fj(t)))))(th)),
        rtol=1e-8)


def test_epsilon_gradient_with_bursts_at_zero_qdv(off_axis):
    # q^d_v = 0: the series is the constant 1, so the port differentiates
    # epsilon on a burst model (the JAX package cannot: ConcretizationTypeError);
    # held against central differences of the port's own forward
    jm_j, jm_t = off_axis
    fj, th = jfit.build_sed_forward(jm_j, SED_FREQS, ('geometry.epsilon',))
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jax.jit(jax.grad(lambda t: jnp.sum(fj(t))))(th)
    ft, th = tfit.build_sed_forward(jm_t, SED_FREQS, ('geometry.epsilon',))

    def loss(t):
        return torch.sum(torch.log(ft(t)))

    g = port_grad(loss, th)[0]
    h = 1e-6
    fd = (float(loss(th + h)) - float(loss(th - h))) / (2 * h)
    assert g == pytest.approx(fd, rel=1e-5)


def test_wofz_derivative_matches_finite_differences():
    x = torch.linspace(-12.0, 12.0, 49, dtype=torch.float64)
    y = torch.tensor([1e-6, 0.3, 2.0, 8.5, 11.0], dtype=torch.float64)
    xx, yy = (t.contiguous() for t in torch.broadcast_tensors(
        x, y[:, None]))
    c_re, c_im = 1.3, 0.7

    def f(a, b):
        re, im = tvoigt.wofz(a, b)
        return c_re * re + c_im * im

    h = 1e-6
    fd_x = (f(xx + h, yy) - f(xx - h, yy)) / (2 * h)
    fd_y = (f(xx, yy + h) - f(xx, yy - h)) / (2 * h)
    xg, yg = xx.clone().requires_grad_(), yy.clone().requires_grad_()
    f(xg, yg).sum().backward()
    assert float((xg.grad - fd_x).abs().max()) < 1e-8
    assert float((yg.grad - fd_y).abs().max()) < 1e-8
    fw = torch.autograd.forward_ad
    with fw.dual_level():
        tx = fw.unpack_dual(f(fw.make_dual(xx, torch.ones_like(xx)),
                              yy)).tangent
        ty = fw.unpack_dual(f(xx, fw.make_dual(
            yy, torch.ones_like(yy)))).tangent
    assert float((tx - fd_x).abs().max()) < 1e-8
    assert float((ty - fd_y).abs().max()) < 1e-8
    # float32: the same ODE on the float32 value
    x32, y32 = xx.float().requires_grad_(), yy.float().requires_grad_()
    f(x32, y32).sum().backward()
    assert float((x32.grad.double() - fd_x).abs().max()) < 1e-5


def test_float32_forward_and_grad_match_float64(off_axis):
    _, jm_t = off_axis
    free = ('properties.mlr_bj', 'properties.T_0')
    f64, th = tfit.build_sed_forward(jm_t, SED_FREQS, free)
    f32, _ = tfit.build_sed_forward(jm_t, SED_FREQS, free,
                                    dtype=torch.float32)
    a, b = np_(f64(th)), np_(f32(th))
    assert b.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=1e-5)
    g64 = port_grad(lambda t: torch.sum(torch.log(f64(t))), th)
    g32 = port_grad(lambda t: torch.sum(torch.log(f32(t))), th)
    assert np.all(np.isfinite(g32))
    np.testing.assert_allclose(g32, g64, rtol=1e-4)


def _true_sed(p, scale_mlr=2.5, scale_t0=0.6, t_yr=2.0, freqs=SED_FREQS):
    pt = copy.deepcopy(p)
    pt['properties'].update(mlr_bj=p['properties']['mlr_bj'] * scale_mlr,
                            T_0=p['properties']['T_0'] * scale_t0)
    jm = JetModel(pt, device='cpu')
    jm.time = t_yr * YEAR
    return np.nansum(jm.flux_ff(freqs), axis=(1, 2))


def _same_fit(res_t, res_j, tol=1e-9):
    np.testing.assert_allclose(res_t.loss, np.asarray(res_j.loss),
                               rtol=tol, atol=0)
    np.testing.assert_allclose(res_t.theta, np.asarray(res_j.theta),
                               rtol=tol, atol=0)
    for p, v in res_j.values.items():
        assert res_t.values[p] == pytest.approx(v, rel=tol)
    assert res_t.grad_norm == pytest.approx(res_j.grad_norm, rel=1e-7)


def test_short_fit_sed_matches_jax(off_axis):
    jm_j, jm_t = off_axis
    obs = _true_sed(base_params() | {'geometry': dict(
        base_params()['geometry'], inc=60., pa=20.)})
    kw = dict(steps=20, learning_rate=0.05)
    res_j = jfit.fit_sed(jm_j, SED_FREQS, obs, **kw)
    res_t = tfit.fit_sed(jm_t, SED_FREQS, obs, **kw)
    _same_fit(res_t, res_j)
    assert res_t.loss[-1] < res_t.loss[0]
    assert rel_err(res_t.model, np.asarray(res_j.model)) < 1e-9
    # with per-channel errors (chi-squared) and a caller's optimizer: the
    # port's torch.optim.SGD against optax.sgd
    err = 0.05 * obs
    res_j = jfit.fit_sed(jm_j, SED_FREQS, obs, errors=err,
                         optimizer=optax.sgd(1e-4), steps=10)
    res_t = tfit.fit_sed(jm_t, SED_FREQS, obs, errors=err,
                         optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-4),
                         steps=10)
    _same_fit(res_t, res_j)


def test_short_fit_map_matches_jax(off_axis):
    jm_j, jm_t = off_axis
    p = base_params()
    p['geometry'].update(inc=60., pa=20.)
    p['properties']['mlr_bj'] *= 3.0
    jm = JetModel(p, device='cpu')
    jm.time = 2.0 * YEAR
    obs = np.nan_to_num(jm.flux_ff(np.array([1e11]))[0])
    kw = dict(free=('properties.mlr_bj',), steps=20, learning_rate=0.05)
    res_j = jfit.fit_map(jm_j, 1e11, obs, **kw)
    res_t = tfit.fit_map(jm_t, 1e11, obs, **kw)
    _same_fit(res_t, res_j)
    assert res_t.model.shape == (1, 16, 16)


def test_multi_start_statistics(off_axis):
    _, jm_t = off_axis
    p = base_params()
    p['geometry'].update(inc=60., pa=20.)
    obs = _true_sed(p)
    kw = dict(free=('properties.mlr_bj',), steps=15, learning_rate=0.05)
    one = tfit.fit_sed(jm_t, SED_FREQS, obs, **kw)
    # chain 0 is the single start: with no spread every chain is it
    same = tfit.fit_sed(jm_t, SED_FREQS, obs, n_starts=3, start_spread=0.0,
                        **kw)
    np.testing.assert_array_equal(same.loss, one.loss)
    np.testing.assert_array_equal(same.theta, one.theta)
    best = tfit.fit_sed(jm_t, SED_FREQS, obs, n_starts=3, seed=2, **kw)
    assert best.loss[-1] <= one.loss[-1] * (1 + 1e-12)
    again = tfit.fit_sed(jm_t, SED_FREQS, obs, n_starts=3, seed=2, **kw)
    np.testing.assert_array_equal(again.theta, best.theta)


def test_sed_fit_recovers_mlr_and_t0():
    # port-only recovery run: the JAX test's 500-step fit from 2.5x / 0.6x
    p = base_params()
    jm = JetModel(copy.deepcopy(p), device='cpu')
    jm.time = 2.0 * YEAR
    obs = _true_sed(p)
    res = tfit.fit_sed(jm, SED_FREQS, obs, steps=500, learning_rate=0.05)
    assert res.values['properties.mlr_bj'] == pytest.approx(2.5e-7,
                                                            rel=1e-4)
    assert res.values['properties.T_0'] == pytest.approx(6e3, rel=1e-4)
    assert res.loss[-1] < 1e-10 < res.loss[0]
    jm_fit = JetModel(res.param_dict(p), device='cpu')
    jm_fit.time = 2.0 * YEAR
    np.testing.assert_allclose(
        np.nansum(jm_fit.flux_ff(SED_FREQS), axis=(1, 2)), obs, rtol=1e-3)


def _noisy_sed(seed, freqs):
    p = base_params()
    p['properties']['mlr_bj'] = 2e-7
    jm = JetModel(p, device='cpu')
    clean = np.nansum(jm.flux_ff(freqs), axis=(1, 2))
    rng = np.random.default_rng(seed)
    return clean * np.exp(rng.normal(0.0, 0.02, clean.shape))


@pytest.fixture(scope='module')
def laplace_setup():
    """The JAX posterior test's noisy SED and the JAX fit of it (400
    steps), carried across as numpy."""
    p = base_params()
    jm_j, jm_t = model_pair(p, 0.0)
    freqs = np.geomspace(4e10, 3e11, 8)
    noisy = _noisy_sed(5, freqs)
    free = ('properties.mlr_bj', 'properties.T_0')
    res = jfit.fit_sed(jm_j, freqs, noisy, free=free, steps=400,
                       learning_rate=0.05)
    fj, _ = jit_forwards(jfit.build_sed_forward)(jm_j, freqs, free)
    sig, cov = jfit.laplace_uncertainties(fj, res.theta, noisy, free)
    ft, _ = tfit.build_sed_forward(jm_t, freqs, free)
    return dict(free=free, noisy=noisy, theta=np.asarray(res.theta),
                values=res.values, sig=sig, cov=cov, fj=fj, ft=ft,
                freqs=freqs)


def test_laplace_uncertainties_match_jax(laplace_setup):
    s = laplace_setup
    sig_t, cov_t = tfit.laplace_uncertainties(s['ft'], s['theta'],
                                              s['noisy'], s['free'])
    np.testing.assert_allclose(cov_t, s['cov'], rtol=1e-8)
    for p in s['free']:
        assert sig_t[p] == pytest.approx(s['sig'][p], rel=1e-8)
    # theta as a tensor (what a builder returns) gives the same bits
    sig_tt, cov_tt = tfit.laplace_uncertainties(
        s['ft'], torch.as_tensor(s['theta']), s['noisy'], s['free'])
    assert sig_tt == sig_t and np.array_equal(cov_tt, cov_t)
    # absolute chi-squared form, at a point off the optimum
    th = s['theta'] + np.array([0.05, -0.03])
    err = 0.02 * s['noisy']
    sj, cj = jfit.laplace_uncertainties(s['fj'], th, s['noisy'], s['free'],
                                        errors=err)
    st, ct = tfit.laplace_uncertainties(s['ft'], th, s['noisy'], s['free'],
                                        errors=err)
    np.testing.assert_allclose(ct, cj, rtol=1e-8)
    for p in s['free']:
        assert st[p] == pytest.approx(sj[p], rel=1e-8)


def test_sample_posterior_statistics(laplace_setup):
    # the JAX fit test's criteria (tests/test_fit.py:285-315), from the
    # JAX fit's optimum and Laplace covariance, at fewer MALA steps of a
    # larger step (acceptance ~0.8 instead of ~0.98: the chains mix in
    # fewer steps)
    s = laplace_setup
    post = tfit.sample_posterior(s['ft'], s['theta'], s['noisy'],
                                 s['free'], cov=s['cov'], steps=POST_STEPS,
                                 burn=POST_BURN, step_scale=POST_SCALE,
                                 seed=1, chains=2)
    assert post.theta_samples.shape == (2, POST_STEPS - POST_BURN, 2)
    assert 0.3 < post.acceptance <= 1.0
    for path in s['free']:
        smp = post.samples[path]
        assert abs(smp.mean() - s['values'][path]) < 3 * s['sig'][path]
        assert smp.std() == pytest.approx(s['sig'][path], rel=0.3)
        assert post.r_hat[path] < 1.05


POST_STEPS, POST_BURN, POST_SCALE = 250, 50, 1.5


def test_grid_refine_matches_jax():
    p = base_params()
    pt = copy.deepcopy(p)
    pt['geometry']['inc'] = 70.
    pt['properties']['mlr_bj'] = 2e-7
    jm = JetModel(pt, device='cpu')
    obs = np.nansum(jm.flux_ff(SED_FREQS), axis=(1, 2))
    jm_j, jm_t = model_pair(p, 0.0)
    kw = dict(grid={'geometry.inc': [50., 70.]},
              free=('properties.mlr_bj',), steps=5, learning_rate=0.05)
    res_j = jfit.fit_grid_refine(jm_j, SED_FREQS, obs, **kw)
    res_t = tfit.fit_grid_refine(jm_t, SED_FREQS, obs, **kw)
    assert res_t.node == res_j.node
    _same_fit(res_t.best, res_j.best)
    for (n_t, l_t), (n_j, l_j) in zip(res_t.table, res_j.table):
        assert n_t == n_j and l_t == pytest.approx(l_j, rel=1e-9)


def test_refusals_match_jax(off_axis):
    jm_j, jm_t = off_axis
    for fit in (jfit, tfit):
        jm = jm_j if fit is jfit else jm_t
        with pytest.raises(ValueError, match="unsupported free parameter"):
            fit.build_sed_forward(jm, SED_FREQS, ('properties.n_0',))
        with pytest.raises(ValueError, match="only meaningful in the RRL"):
            fit.build_sed_forward(jm, SED_FREQS, ('nonlte.b_n2',))
        with pytest.raises(ValueError, match="unsupported free parameter"):
            fit.fit_grid_refine(jm, SED_FREQS, np.ones(4),
                                grid={'grid.c_size': [0.5]})
