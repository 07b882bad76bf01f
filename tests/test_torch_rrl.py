"""The port's RRL slice against the JAX package's, on the CPU.

* ``ops/voigt.wofz`` at float64 to 1e-12 of max|w| over x, y in [0, 1e3]
  (y = 0 and y < 3e-5 included), and at float32 to 1e-6, through the
  plain version on CPU tensors (the kernel's wrapper refuses them);
* ``ops/rrls``, ``ops/physics`` and the RRL half of ``ops/radtrans`` at
  float64 to 1e-9;
* the plain versions of the RRL kernels (tile and cube) against
  ``rrl_tiles_pallas``/``rrl_cube_pallas`` in the Pallas interpreter to
  1e-5, over all-far, all-near and mixed channel sets, with empty tiles
  and a ragged cube; ``segment_tile_maps`` likewise;
* ``JetModel`` float64 RRL products, LTE and non-LTE, to 1e-6 of the JAX
  package's (the RRL parity contract of docs/MIGRATION.md); the float32
  tile path to 1e-4 of JAX's float32 interpret path and 3e-3 of its
  float64 oracle, on axis and at inc=55/pa=30 where travel times go
  negative (as tests/test_fused_paths_cpu.py).

Inputs are made with numpy from a seed and handed to both packages.
"""
import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rajepy_tpu import JetModel as JaxJetModel
from rajepy_tpu.ops import departure as jdep
from rajepy_tpu.ops import pallas_kernels as pk
from rajepy_tpu.ops import physics as jphys
from rajepy_tpu.ops import radtrans as jrt
from rajepy_tpu.ops import rrls as jrrl
from rajepy_tpu.ops import voigt as jvoigt
from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch import constants as tconst
from rajepy_tpu_torch.models.fields import static_fields_from_numpy
from rajepy_tpu_torch.ops import departure as tdep
from rajepy_tpu_torch.ops import kernels as kn
from rajepy_tpu_torch.ops import physics as tphys
from rajepy_tpu_torch.ops import radtrans as trt
from rajepy_tpu_torch.ops import rrls as trrl
from rajepy_tpu_torch.ops import voigt as tvoigt
from rajepy_tpu_torch.utils import profiling
from tests.torch_one_thread import one_thread  # noqa: F401

YEAR = 31536000.0
LINE = 'H58a'
NU0 = trt.RRLCoeffs(LINE).nu0
FREQS = np.linspace(NU0 * 0.99998, NU0 * 1.00002, 5)


@pytest.fixture()
def forced_interpret():
    pk.force_interpret(True)
    try:
        yield
    finally:
        pk.force_interpret(False)


def _rel(got, want):
    got = np.nan_to_num(np.asarray(got, dtype=float))
    want = np.nan_to_num(np.asarray(want, dtype=float))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    return np.max(np.abs(got - want)) / scale


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a)).to(dtype)


# --------------------------------------------------------------------------- #
# ops: voigt, rrls, physics, radtrans
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-6)])
def test_wofz_matches_jax(dtype, tol):
    xs = np.concatenate([[0.0], np.logspace(-3, 3, 61)])
    ys = np.concatenate([[0.0, 1e-10, 1e-6, 2.9e-5, 3.1e-5],
                         np.logspace(-4, 3, 43)])
    x, y = (a.astype(dtype) for a in np.meshgrid(xs, ys))
    jre, jim = (np.asarray(a) for a in jvoigt.wofz(jnp.asarray(x),
                                                   jnp.asarray(y)))
    tdt = getattr(torch, dtype)
    before = {k: profiling.COUNTERS.get(k, 0)
              for k in ('voigt.wofz_evals', 'voigt.wofz_kernel')}
    launches = kn.LAUNCHES['wofz']
    tre, tim = (a.numpy() for a in tvoigt.wofz(_t(x, tdt), _t(y, tdt)))
    # a CPU tensor takes the plain version: one evaluation, no kernel
    assert profiling.COUNTERS['voigt.wofz_evals'] == \
        before['voigt.wofz_evals'] + 1
    assert profiling.COUNTERS.get('voigt.wofz_kernel', 0) == \
        before['voigt.wofz_kernel']
    assert kn.LAUNCHES['wofz'] == launches
    assert tre.dtype == np.dtype(dtype)
    scale = np.abs(jre + 1j * jim).max()
    assert np.abs(tre - jre).max() / scale < tol
    assert np.abs(tim - jim).max() / scale < tol


def test_wofz_kernel_wrapper_refuses_what_it_cannot_launch():
    x = torch.zeros(3, dtype=torch.float64)
    launches = kn.LAUNCHES['wofz']
    with pytest.raises(ValueError, match='CUDA'):
        kn.wofz_kernel(x, x)
    assert kn.LAUNCHES['wofz'] == launches
    # the constants are the plain version's, rounded to each dtype
    for dtype, np_dtype, n in ((torch.float64, np.float64, 128),
                               (torch.float32, np.float32, 32)):
        ell, a = tvoigt._weideman_coeffs(n)
        c = kn._wofz_struct(dtype)
        np.testing.assert_array_equal(np.asarray(c.a[:]), a.astype(np_dtype))
        assert c.ell == np_dtype(ell)


def test_weideman_coeffs_match_jax():
    for n in (16, 32, 128):
        ell_j, a_j = jvoigt._weideman_coeffs(n)
        ell_t, a_t = tvoigt._weideman_coeffs(n)
        assert ell_t == ell_j
        np.testing.assert_array_equal(a_t, a_j)


def _line_inputs(seed=0, n=200):
    rng = np.random.default_rng(seed)
    return {
        'freq': NU0 + rng.uniform(-3e6, 3e6, n),
        'temp': rng.uniform(3e3, 2e4, n),
        'ne': 10 ** rng.uniform(3, 9, n),
        'fwhm_g': rng.uniform(1e5, 1e6, n),
        'fwhm_l': 10 ** rng.uniform(2, 6, n),
        'tau_c': 10 ** rng.uniform(-4, 1, n),
        'tau_l': 10 ** rng.uniform(-6, 0, n),
        'b1': rng.uniform(0.8, 1.0, n),
        'b2': rng.uniform(0.8, 1.0, n),
        'v': rng.uniform(-200, 200, n),
    }


def _rrl_cases():
    """name -> callable(module-set, inputs) for the rrls/physics surface."""
    def prof(m):
        return m['rrl'].phi_voigt_nu(NU0, m['a']('fwhm_l'), m['a']('fwhm_g'),
                                     m['a']('freq'))
    return {
        'deltanu_g': lambda m: m['rrl'].deltanu_g(NU0, m['a']('temp'), 'H'),
        'deltanu_l': lambda m: m['rrl'].deltanu_l(m['a']('ne'), 58, 1),
        'deltanu_v': lambda m: m['rrl'].deltanu_v(m['a']('fwhm_g'),
                                                  m['a']('fwhm_l')),
        'ni_from_ne_He': lambda m: m['rrl'].ni_from_ne(m['a']('ne'), 'He'),
        'phi_thermal_nu': lambda m: m['rrl'].phi_thermal_nu(
            NU0, m['a']('fwhm_g'), m['a']('freq')),
        'phi_stark_nu': lambda m: m['rrl'].phi_stark_nu(
            NU0, m['a']('fwhm_l'), m['a']('freq')),
        'phi_voigt_nu': prof,
        'phi_thermal_nu_integrated': lambda m:
            m['rrl'].phi_thermal_nu_integrated(m['a']('freq'), NU0,
                                               m['a']('fwhm_g'), 1e5),
        'phi_stark_nu_integrated': lambda m:
            m['rrl'].phi_stark_nu_integrated(m['a']('freq'), NU0,
                                             m['a']('fwhm_l'), 1e5),
        'phi_voigt_nu_integrated_qa13': lambda m:
            m['rrl'].phi_voigt_nu_integrated(m['a']('freq'), NU0,
                                             m['a']('fwhm_g'),
                                             m['a']('fwhm_l'), 1e5),
        'phi_voigt_nu_integrated_quad': lambda m:
            m['rrl'].phi_voigt_nu_integrated(m['a']('freq'), NU0,
                                             m['a']('fwhm_g'),
                                             m['a']('fwhm_l'), 1e5,
                                             average=False, method='quad'),
        'kappa_l': lambda m: m['rrl'].kappa_l(
            m['a']('freq'), 58, jrrl.f_n1n2(58, 1), prof(m), m['a']('ne'),
            m['a']('ne'), m['a']('temp'), 1, jrrl.energy_n(58, 'H')),
        'kappa_l_average': lambda m: m['rrl'].kappa_l_average(
            m['a']('freq'), 58, jrrl.f_n1n2(58, 1), prof(m), m['a']('ne'),
            m['a']('ne'), m['a']('temp'), 1, jrrl.energy_n(58, 'H'), 1e5),
        'line_intensity_lte': lambda m: m['rrl'].line_intensity_lte(
            m['a']('freq'), m['a']('temp'), m['a']('tau_c'),
            m['a']('tau_l')),
        'line_continuum_ratio_lte': lambda m:
            m['rrl'].line_continuum_ratio_lte(m['a']('tau_c'),
                                              m['a']('tau_l')),
        'beta_coeff': lambda m: m['rrl'].beta_coeff(
            m['a']('freq'), m['a']('temp'), m['a']('b1'), m['a']('b2')),
        'eta_coeff': lambda m: m['rrl'].eta_coeff(
            m['a']('b1'), m['a']('b2'), m['a']('tau_c'), m['a']('tau_l'),
            m['a']('b1')),
        'tau_nu_coeff': lambda m: m['rrl'].tau_nu_coeff(
            m['a']('b2'), m['a']('tau_c'), m['a']('tau_l'), m['a']('b1')),
        'line_continuum_ratio_nonlte': lambda m:
            m['rrl'].line_continuum_ratio_nonlte(
                m['a']('b1'), m['a']('tau_l') + m['a']('tau_c'),
                m['a']('tau_c')),
        'line_intensity_nonlte': lambda m: m['rrl'].line_intensity_nonlte(
            m['a']('freq'), m['a']('temp'), m['a']('tau_c'),
            m['a']('tau_l'), m['a']('b1'), m['a']('b2')),
        'blackbody_nu': lambda m: m['phys'].blackbody_nu(m['a']('freq'),
                                                         m['a']('temp')),
        'doppler_shift': lambda m: m['phys'].doppler_shift(NU0, m['a']('v')),
    }


# kappa_l_average's closed-form channel integral is the difference of two
# k T / h + nu terms (~2e14 Hz) that differ by ~bw h nu / k T (~20 Hz):
# one ulp of exp in either package moves the result by ~1e-6
_PHYSICS_TOL = {'kappa_l_average': 1e-5}


@pytest.mark.parametrize("name", sorted(_rrl_cases()))
def test_rrl_physics_matches_jax_f64(name):
    d = _line_inputs()
    fn = _rrl_cases()[name]
    want = fn({'rrl': jrrl, 'phys': jphys, 'a': lambda k: jnp.asarray(d[k])})
    got = fn({'rrl': trrl, 'phys': tphys, 'a': lambda k: _t(d[k])})
    assert isinstance(got, torch.Tensor)
    assert _rel(got.numpy(), want) < _PHYSICS_TOL.get(name, 1e-9)


def test_beta_coeff_float32_at_radio_lines():
    """beta at H58a with departure coefficients 1e-5 apart (x = h nu / k T
    ~ 2.4e-4), float32 against float64: 1e-6.  The textbook form
    (1 - r e^-x) / (1 - e^-x), which cancels there in float32, is what the
    regrouped form computes in float64 (1e-9)."""
    temp = np.array([5e3, 1e4, 2e4])
    b1, b2 = 0.9998596894694245, 0.9998719368020373
    want = trrl.beta_coeff(_t(NU0), _t(temp), b1, b2)
    got = trrl.beta_coeff(_t(NU0, torch.float32), _t(temp, torch.float32),
                          b1, b2)
    assert got.dtype == torch.float32
    assert _rel(got.double().numpy(), want.numpy()) < 1e-6
    x = tconst.H * NU0 / (tconst.K_B * temp)
    textbook = (1.0 - (b2 / b1) * np.exp(-x)) / (1.0 - np.exp(-x))
    np.testing.assert_allclose(want.numpy(), textbook, rtol=1e-9)


def test_nonlte_line_centre_float32_matches_float64(monkeypatch):
    """``nonlte_and_surveys``' line-centre fluxes (its jet at 24x60x24,
    H58a, scalar and per-sightline departure coefficients) on float32
    models through the kernels' plain versions against float64: 1e-5 with
    scalar coefficients, 1e-3 with maps (their float32 b_n2 - b_n1).  With
    the textbook beta the non-LTE flux is over 1e-4 off.  Prints the
    readings (``pytest -s``)."""
    from rajepy_tpu_torch.examples import bundled_params
    p = bundled_params()
    p['grid'].update(n_x=24, n_y=60, n_z=24, l_z=None)
    freqs = np.linspace(NU0 - 2e6, NU0 + 2e6, 9)

    def line_centre(dtype):
        jm = JetModel(copy.deepcopy(p), dtype=dtype, device='cpu')
        jm.time = 2.0 * YEAR
        maps = jm.departure_coefficient_maps(LINE)
        s = [np.nansum(jm.flux_rrl(LINE, freqs, **kw), axis=(1, 2))[4]
             for kw in ({}, {'lte': False},
                        {'lte': False, 'departure_coeffs': maps})]
        return np.array([s[0], s[1], s[1] / s[0], s[2]], dtype=float)

    want = line_centre(torch.float64)
    rel = np.abs(line_centre(torch.float32) / want - 1.0)
    print(f"float32 against float64, LTE / non-LTE / ratio / maps: {rel}")
    assert np.all(rel[:3] < 1e-5) and rel[3] < 1e-3

    def textbook(freq, temp, b_n1, b_n2):
        ex = torch.exp(-tconst.H * trrl._t(freq) / (tconst.K_B * temp))
        return (1.0 - (b_n2 / b_n1) * ex) / (1.0 - ex)
    monkeypatch.setattr(trrl, 'beta_coeff', textbook)
    rel_textbook = np.abs(line_centre(torch.float32) / want - 1.0)
    print(f"with the textbook beta: {rel_textbook}")
    assert rel_textbook[1] > 1e-4


def test_rrl_scalars_match_jax():
    for line in ('H58a', 'He42b', 'C91a', 'H110d'):
        el, n, dn = trrl.rrl_parser(line)
        assert (el, n, dn) == jrrl.rrl_parser(line)
        assert trrl.rrl_nu_0(el, n, dn) == jrrl.rrl_nu_0(el, n, dn)
        assert trrl.energy_n(n, el) == jrrl.energy_n(n, el)
        assert trrl.f_n1n2(n, dn) == jrrl.f_n1n2(n, dn)
        assert tphys.nu_rrl(n, dn, el) == pytest.approx(
            float(jphys.nu_rrl(n, dn, el)), rel=1e-15)
        c_t, c_j = trt.RRLCoeffs(line), jrt.RRLCoeffs(line)
        assert vars(c_t) == vars(c_j)


def test_departure_copy_matches_jax():
    t_e = np.array([3e3, 8e3, 2e4])
    n_e = np.array([1e3, 1e6, 1e10])
    for n in (58, 110):
        np.testing.assert_array_equal(tdep.b_n(n, t_e, n_e),
                                      jdep.b_n(n, t_e, n_e))
    assert tdep.b_n_pair(58, 1, 1e4, 1e6, 'hi') == \
        jdep.b_n_pair(58, 1, 1e4, 1e6, 'hi')
    assert tdep.b_n_pair_systematic(58, 1, 1e4, 1e6) == \
        jdep.b_n_pair_systematic(58, 1, 1e4, 1e6)


def _grid_fields(seed=1, shape=(6, 20, 5)):
    """A small random jet: fields as numpy, ~70% of the cells inside."""
    rng = np.random.default_rng(seed)
    inside = rng.random(shape) < 0.7
    return {
        'temp': np.where(inside, rng.uniform(5e3, 2e4, shape), 0.0),
        'n_es': np.where(inside, 10 ** rng.uniform(4, 8, shape), 0.0),
        'vy': np.where(inside, rng.uniform(-150, 150, shape), 0.0),
        'ds': np.where(inside, rng.uniform(1e12, 1e13, shape), 0.0),
        'inside': inside,
    }


def test_radtrans_rrl_matches_jax_f64():
    d = _grid_fields()
    fj = [jnp.asarray(d[k]) for k in ('temp', 'n_es', 'vy', 'ds', 'inside')]
    ft = [_t(d[k]) if k != 'inside' else torch.as_tensor(d[k])
          for k in ('temp', 'n_es', 'vy', 'ds', 'inside')]
    cj, ct = jrt.RRLCoeffs(LINE), trt.RRLCoeffs(LINE)
    fr = np.linspace(NU0 - 2e6, NU0 + 2e6, 4)
    tau_j = jrt.tau_rrl_maps(cj, jnp.asarray(fr), *fj)
    tau_t = trt.tau_rrl_maps(ct, _t(fr), *ft)
    assert _rel(tau_t, tau_j) < 1e-9
    for g, w in zip(trt.tau_rrl_precompute(ct, *ft),
                    jrt.tau_rrl_precompute(cj, *fj)):
        assert _rel(g, w) < 1e-9
    assert _rel(trt.tau_rrl_cube(ct, _t(fr[:2]), *ft),
                jrt.tau_rrl_cube(cj, jnp.asarray(fr[:2]), *fj)) < 1e-9
    tbar_j, any_j = jrt.mean_temperature_map(fj[0], fj[4])
    tbar_t, any_t = trt.mean_temperature_map(ft[0], ft[4])
    tau_c = 10 ** np.random.default_rng(2).uniform(-3, 0, tau_t.shape)
    b1 = np.random.default_rng(3).uniform(0.9, 1.0, tau_t.shape[1:])
    pairs = [
        (trt.intensity_rrl_maps(_t(fr), tbar_t, _t(tau_c), tau_t, any_t),
         jrt.intensity_rrl_maps(jnp.asarray(fr), tbar_j, jnp.asarray(tau_c),
                                tau_j, any_j)),
        (trt.tau_rrl_maps_nonlte(_t(fr), tbar_t, any_t, tau_t, _t(b1), 0.97),
         jrt.tau_rrl_maps_nonlte(jnp.asarray(fr), tbar_j, any_j, tau_j,
                                 jnp.asarray(b1), 0.97)),
        (trt.intensity_rrl_maps_nonlte(_t(fr), tbar_t, _t(tau_c), tau_t,
                                       any_t, 0.95, _t(b1)),
         jrt.intensity_rrl_maps_nonlte(jnp.asarray(fr), tbar_j,
                                       jnp.asarray(tau_c), tau_j, any_j,
                                       0.95, jnp.asarray(b1))),
        (trt.tau_ff_maps(_t(fr), *ft[:2], ft[3], ft[4], 1e4, False),
         jrt.tau_ff_maps(jnp.asarray(fr), *fj[:2], fj[3], fj[4], 1e4,
                         False)),
    ]
    for got, want in pairs:
        assert _rel(got, want) < 1e-9


# --------------------------------------------------------------------------- #
# The RRL kernels' plain versions against the Pallas kernels (interpreter)
# --------------------------------------------------------------------------- #
def _factors(rng, shape, zero_frac=0.3):
    """Float32 kernel factors (amp, rest, scale, y_voigt, hkT): |rest|
    <= 1e5 Hz, scale in [1/8e5, 1/2e5] per Hz, y_voigt in [0, 3]."""
    amp = rng.random(shape) * 1e-3
    amp[rng.random(shape) < zero_frac] = 0.0
    rest = rng.uniform(-1e5, 1e5, shape)
    scale = 1.0 / rng.uniform(2e5, 8e5, shape)
    yv = rng.uniform(0.0, 3.0, shape)
    hkt = 4.8e-11 / rng.uniform(5e3, 2e4, shape)
    return [a.astype(np.float32) for a in (amp, rest, scale, yv, hkt)]


# channel offsets from nu0 [Hz]: every cell far (|x| + y > 8), every cell
# near, and a mix
CHANNEL_SETS = {
    'all_far': np.linspace(1e7, 5e7, 4),
    'all_near': np.linspace(-2e5, 2e5, 5),
    'mixed': np.linspace(-4e6, 4e6, 6),
}


def _branch_share(freqs_off, f):
    x = (freqs_off[:, None] - f[1].ravel()) * f[2].ravel()
    return np.mean(np.abs(x) + f[3].ravel() > kn.FAR_CUT)


@pytest.mark.parametrize("channels", sorted(CHANNEL_SETS))
def test_rrl_tile_plain_matches_pallas(channels):
    rng = np.random.default_rng(4)
    f = _factors(rng, (3,) + kn.TILE)
    f[0][1] = 0.0                                   # a fully empty tile
    fo = CHANNEL_SETS[channels].astype(np.float32)
    share = _branch_share(fo, f)
    assert {'all_far': share == 1, 'all_near': share == 0,
            'mixed': 0 < share < 1}[channels]
    nu0 = float(NU0)
    want = np.asarray(pk.rrl_tiles_pallas(
        jnp.asarray(fo), *(jnp.asarray(a) for a in f), nu0=nu0,
        interpret=True))
    got = kn.rrl_tile_partials(torch.as_tensor(fo),
                               *(torch.as_tensor(a) for a in f), nu0)
    assert got.dtype == torch.float32
    assert got.shape == (3, len(fo), kn.TILE[0], kn.TILE[2])
    assert not got[1].any()                        # the empty tile
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("channels", sorted(CHANNEL_SETS))
def test_rrl_cube_plain_matches_pallas(channels):
    rng = np.random.default_rng(5)
    f = _factors(rng, (11, 70, 150))               # ragged in every axis
    f[0][:8] = 0.0                                  # an amp = 0 slab
    fo = CHANNEL_SETS[channels].astype(np.float32)
    nu0 = float(NU0)
    want = np.asarray(pk.rrl_cube_pallas(
        jnp.asarray(fo), *(jnp.asarray(a) for a in f), nu0=nu0,
        interpret=True))
    got = kn.rrl_cube(torch.as_tensor(fo), *(torch.as_tensor(a) for a in f),
                      nu0)
    assert got.shape == (len(fo), 11, 150)
    assert not got[:, :8].any()
    assert _rel(got.numpy(), want) < 1e-5


def test_segment_tile_maps_matches_jax():
    rng = np.random.default_rng(6)
    parts = rng.random((7, 3, 8, 128)).astype(np.float32)
    seg = np.array([0, 0, 3, 1, 3, 2, 0], dtype=np.int32)
    want = np.asarray(pk.segment_tile_maps(jnp.asarray(parts),
                                           jnp.asarray(seg), 16, 200))
    got = kn.segment_tile_maps(torch.as_tensor(parts),
                               torch.as_tensor(seg, dtype=torch.int64),
                               16, 200)
    assert got.shape == (3, 16, 200)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_rrl_wrappers_reject_other_devices():
    f = [torch.zeros((1,) + kn.TILE, device='meta') for _ in range(5)]
    with pytest.raises(ValueError, match='unsupported device'):
        kn.rrl_tile_partials(torch.zeros(2, device='meta'), *f, 1e10)
    with pytest.raises(ValueError, match='unsupported device'):
        kn.rrl_cube(torch.zeros(2, device='meta'),
                    *(torch.zeros((2, 3, 4), device='meta')
                      for _ in range(5)), 1e10)
    idx = torch.zeros(2, dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        kn.rrl_tiles(torch.zeros(2, device='meta'), *f, 1e10, idx[:1], idx,
                     8, 128)
    with pytest.raises(ValueError, match='unsupported device'):
        kn.rrl_row_activity(torch.zeros((2, 3, 4), device='meta'))


def _flux_stage_inputs(dtype, reynolds, seed=3, n_chan=7, nx=6, nz=8):
    """The channel stage's inputs: a silhouette with ~40% of the pixels
    outside (T = 0 there, as mean_temperature_from_sums gives), tau_c = 0
    on some inside pixels, and optically thin (1e-9), thick (30) and
    moderate line opacities."""
    rng = np.random.default_rng(seed)
    freqs = _t(np.linspace(NU0 - 5e7, NU0 + 5e7, n_chan), dtype)
    scale = trt.tau_ff_channel_scale(freqs, 1e4, reynolds)
    any_in = torch.as_tensor(rng.uniform(size=(nx, nz)) > 0.4)
    tau_c0 = rng.uniform(0.0, 3.0, (nx, nz)) * (rng.uniform(size=(nx, nz))
                                                > 0.2)
    a_map = _t(tau_c0 / float(scale[n_chan // 2]), dtype)
    tbar = _t(np.where(any_in.numpy(), rng.uniform(5e3, 1.2e4, (nx, nz)),
                       0.0), dtype)
    kind = rng.integers(0, 3, (n_chan, nx, nz))
    tau_l = _t(np.choose(kind, [np.full(kind.shape, 1e-9),
                                np.full(kind.shape, 30.0),
                                rng.uniform(0.0, 2.0, kind.shape)]), dtype)
    return freqs, scale, a_map, tbar, any_in, tau_l


@pytest.mark.parametrize("reynolds", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("contsub", [False, True])
def test_rrl_flux_maps_lte_is_the_chain_it_replaced(contsub, dtype,
                                                    reynolds):
    """The plain channel stage, and the wrapper on CPU tensors, equal bit
    for bit the eager composition rrl_rt_products ran before; the wrapper
    counts the stage and launches nothing."""
    freqs, scale, a_map, tbar, any_in, tau_l = _flux_stage_inputs(
        dtype, reynolds)
    csize, dist = 0.5, 120.0
    tau_c = scale[:, None, None] * a_map[None]
    want = trt.intensity_rrl_maps(freqs, tbar, tau_c, tau_l, any_in) * \
        trt.flux_scale_jy(csize, dist)
    if not contsub:
        want = want + trt.flux_ff_maps(freqs, tau_c, tbar, any_in, csize,
                                       dist)
    got = trt.rrl_flux_maps_lte(freqs, scale, a_map, tbar, any_in, tau_l,
                                csize, dist, contsub)
    assert got.dtype == dtype and torch.equal(got, want)
    stages = profiling.COUNTERS.get('rt.rrl_flux_stages', 0)
    kernel = profiling.COUNTERS.get('rt.rrl_flux_kernel', 0)
    launches = kn.LAUNCHES['rrl_flux']
    assert torch.equal(kn.rrl_flux_maps(freqs, scale, a_map, tbar, any_in,
                                        tau_l, csize, dist, contsub), want)
    assert profiling.COUNTERS['rt.rrl_flux_stages'] == stages + 1
    assert profiling.COUNTERS.get('rt.rrl_flux_kernel', 0) == kernel
    assert kn.LAUNCHES['rrl_flux'] == launches
    # outside the silhouette exactly 0; the thin lines do not cancel
    assert bool((want[:, ~any_in] == 0).all())
    assert bool((want[:, any_in] > 0).all())


def test_rrl_flux_maps_refuses_grad_and_other_devices():
    freqs, scale, a_map, tbar, any_in, tau_l = _flux_stage_inputs(
        torch.float64, False)
    stages = profiling.COUNTERS.get('rt.rrl_flux_stages', 0)
    for i in (1, 2, 5):
        args = [freqs, scale, a_map, tbar, any_in, tau_l]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(ValueError, match='no backward'):
            kn.rrl_flux_maps(*args, 0.5, 120.0, False)
    with pytest.raises(ValueError, match='no backward'):
        kn.rrl_flux_maps(freqs, scale, a_map, tbar, any_in, tau_l, 0.5,
                         torch.full((), 120.0, dtype=torch.float64,
                                    requires_grad=True), False)
    with pytest.raises(ValueError, match='unsupported device'):
        kn.rrl_flux_maps(freqs, scale, a_map, tbar, any_in,
                         tau_l.to('meta'), 0.5, 120.0, False)
    assert profiling.COUNTERS.get('rt.rrl_flux_stages', 0) == stages


# --------------------------------------------------------------------------- #
# JetModel
# --------------------------------------------------------------------------- #
_PAIRS = {}


def _pair(params, inc=90.0, pa=0.0, jax_dtype=jnp.float64, dtype='parity',
          t_yr=2.0):
    """(JAX model, port model) of the conftest jet, cached per config so
    the JAX package's compiled programs are reused within this file."""
    key = (inc, pa, str(jax_dtype), str(dtype), t_yr)
    if key not in _PAIRS:
        p = copy.deepcopy(params)
        p['geometry'].update(inc=inc, pa=pa)
        jm_j = JaxJetModel(copy.deepcopy(p), dtype=jax_dtype)
        jm_t = JetModel(copy.deepcopy(p), dtype=dtype, device='cpu')
        jm_j.time = jm_t.time = t_yr * YEAR
        _PAIRS[key] = (jm_j, jm_t)
    return _PAIRS[key]


@pytest.mark.parametrize("contsub", [False, True])
def test_rrl_rt_products_match_jax_f64(model_params, contsub):
    jm_j, jm_t = _pair(model_params)
    assert not jm_t._use_fused_rrl()
    got = jm_t.rrl_rt_products(LINE, FREQS, contsub=contsub)
    want = jm_j.rrl_rt_products(LINE, FREQS, contsub=contsub)
    for name, g, w in zip(('em', 'tau_l', 'flux'), got, want):
        assert _rel(g, w) < 1e-6, name
    # the separate entry points give the same products
    np.testing.assert_allclose(jm_t.optical_depth_rrl(LINE, FREQS), got[1],
                               rtol=1e-12)
    np.testing.assert_allclose(
        jm_t.flux_rrl(LINE, FREQS, contsub=contsub), got[2], rtol=1e-9)


def test_rrl_rt_products_count_the_stage_not_the_kernel_on_the_cpu(
        model_params):
    """A float32 LTE run counts one channel stage, through the wrapper's
    plain version; a non-LTE run and a float64 run keep the eager chain and
    count none."""
    jm32 = JetModel(copy.deepcopy(model_params), dtype=torch.float32,
                    device='cpu')
    jm32.time = 2.0 * YEAR
    _, jm64 = _pair(model_params)
    stages = profiling.COUNTERS.get('rt.rrl_flux_stages', 0)
    kernel = profiling.COUNTERS.get('rt.rrl_flux_kernel', 0)
    jm32.rrl_rt_products(LINE, FREQS, contsub=False)
    assert profiling.COUNTERS['rt.rrl_flux_stages'] == stages + 1
    jm32.rrl_rt_products(LINE, FREQS, lte=False, departure_coeffs=(0.9, 0.91))
    jm64.rrl_rt_products(LINE, FREQS, contsub=False)
    assert profiling.COUNTERS['rt.rrl_flux_stages'] == stages + 1
    assert profiling.COUNTERS.get('rt.rrl_flux_kernel', 0) == kernel


def test_rrl_entry_points_match_jax_f64(tmp_path, model_params):
    jm_j, jm_t = _pair(model_params)
    for name, call in [
            ('tau scalar', lambda m: m.optical_depth_rrl(LINE, float(NU0))),
            ('tau cube', lambda m: m.optical_depth_rrl(LINE, FREQS[1:3],
                                                       collapse=False)),
            ('intensity', lambda m: m.intensity_rrl(LINE, FREQS))]:
        assert _rel(call(jm_t), call(jm_j)) < 1e-6, name
    with pytest.raises(ValueError, match='LTE-only'):
        jm_t.optical_depth_rrl(LINE, FREQS, lte=False, collapse=False)
    path = str(tmp_path / 'tau.fits')
    tau = jm_t.optical_depth_rrl(LINE, FREQS, savefits=path)
    from rajepy_tpu.io.fits import read_fits
    data, hdr = read_fits(path)
    assert data.shape == (len(FREQS), jm_t.nz, jm_t.nx)
    np.testing.assert_allclose(data, tau.transpose(0, 2, 1), rtol=1e-6)
    assert hdr['CTYPE3'] == 'FREQ' and hdr['BUNIT'] == 'dimensionless'


@pytest.mark.parametrize("coeffs", ["table", "maps", "scalars"])
def test_rrl_nonlte_matches_jax_f64(model_params, coeffs):
    jm_j, jm_t = _pair(model_params)
    if coeffs == 'table':
        dc_t = dc_j = None
        assert jm_t.departure_coefficients(LINE) == pytest.approx(
            jm_j.departure_coefficients(LINE), rel=1e-9)
        assert jm_t.departure_coefficient_systematic(LINE) == \
            pytest.approx(jm_j.departure_coefficient_systematic(LINE),
                          rel=1e-6)
        assert jm_t.departure_coefficients_at_scale(LINE, 'lo') == \
            pytest.approx(jm_j.departure_coefficients_at_scale(LINE, 'lo'),
                          rel=1e-9)
    elif coeffs == 'maps':
        dc_t = jm_t.departure_coefficient_maps(LINE)
        dc_j = jm_j.departure_coefficient_maps(LINE)
        for g, w in zip(dc_t, dc_j):
            assert g.shape == (jm_t.nx, jm_t.nz)
            np.testing.assert_allclose(g, w, rtol=1e-9)
    else:
        dc_t = dc_j = (0.96, 0.98)
    got = jm_t.rrl_rt_products(LINE, FREQS, lte=False, departure_coeffs=dc_t)
    want = jm_j.rrl_rt_products(LINE, FREQS, lte=False,
                                departure_coeffs=dc_j)
    for name, g, w in zip(('em', 'tau', 'flux'), got, want):
        assert _rel(g, w) < 1e-6, name
    assert _rel(jm_t.intensity_rrl(LINE, FREQS, lte=False,
                                   departure_coeffs=dc_t),
                jm_j.intensity_rrl(LINE, FREQS, lte=False,
                                   departure_coeffs=dc_j)) < 1e-6


def test_rrl_from_jax_fields_matches_jax_f64(model_params):
    """RRL RT alone: the port fed the JAX package's own fields."""
    p = copy.deepcopy(model_params)
    jm_j = JaxJetModel(copy.deepcopy(p), dtype=jnp.float64)
    jm_t = JetModel(copy.deepcopy(p), dtype='parity', device='cpu')
    jm_j.time = jm_t.time = 0.6 * YEAR
    jm_t._fields = static_fields_from_numpy(jm_j._ensure_fields(), 'cpu',
                                            torch.float64)
    got = jm_t.rrl_rt_products(LINE, FREQS)
    want = jm_j.rrl_rt_products(LINE, FREQS)
    for name, g, w in zip(('em', 'tau_l', 'flux'), got, want):
        assert _rel(g, w) < 1e-6, name


@pytest.mark.parametrize("inc,pa", [(90.0, 0.0), (55.0, 30.0)])
def test_f32_rrl_tile_path_matches_jax(forced_interpret, model_params, inc,
                                       pa):
    jm_j32, jm_t32 = _pair(model_params, inc, pa, jnp.float32,
                           torch.float32, t_yr=2.2)
    jm_j64, _ = _pair(model_params, inc, pa, t_yr=2.2)
    assert jm_t32._use_fused_rrl() and jm_t32._rrl_tiles() is not None
    if (inc, pa) != (90.0, 0.0):
        assert jm_t32._ts_pack_offset > 1.0     # negative ts present
    cases = [
        ('tau', lambda m: m.optical_depth_rrl(LINE, FREQS)),
        ('products', lambda m: m.rrl_rt_products(LINE, FREQS,
                                                 contsub=False)[2]),
        ('nonlte', lambda m: m.rrl_rt_products(
            LINE, FREQS, lte=False, departure_coeffs=(0.96, 0.98))[1]),
    ]
    for name, call in cases:
        got = call(jm_t32)
        assert got.dtype == np.float32
        assert _rel(got, call(jm_j32)) < 1e-4, f"{name} vs JAX f32"
        assert _rel(got, call(jm_j64)) < 3e-3, f"{name} vs JAX f64"


def test_f32_rrl_cube_branch_when_no_tile_is_active(forced_interpret,
                                                    model_params):
    """A grid inside the launch radius holds no jet cell: the float32 RRL
    path takes the full-grid (cube kernel) branch, as the JAX package."""
    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=8, n_y=16, n_z=8, c_size=0.01)
    jm_j = JaxJetModel(copy.deepcopy(p), dtype=jnp.float32)
    jm_t = JetModel(copy.deepcopy(p), dtype=torch.float32, device='cpu')
    jm_j.time = jm_t.time = 2.0 * YEAR
    assert jm_t._rrl_tiles() is None
    em, tau, flux = jm_t.rrl_rt_products(LINE, FREQS)
    em_j, tau_j, flux_j = jm_j.rrl_rt_products(LINE, FREQS)
    assert tau.shape == flux.shape == (len(FREQS), 8, 8)
    for g, w in ((em, em_j), (tau, tau_j), (flux, flux_j)):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert not g.any()
