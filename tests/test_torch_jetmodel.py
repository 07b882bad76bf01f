"""The port's JetModel continuum surface against the JAX package's, on the
CPU.

* float64: every continuum product to 1e-9 relative, the JAX package's
  continuum parity contract (docs/MIGRATION.md);
* float32: the compacted tile path (the plain versions of the epoch
  kernels) against the JAX f32 interpret path and the JAX f64 oracle, on
  axis and at inc=55/pa=30 where travel times go negative: 2e-4, as
  tests/test_fused_paths_cpu.py;
* FITS products and pickled checkpoints interchange with the JAX package.
"""
import copy
import pickle

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rajepy_tpu import JetModel as JaxJetModel
from rajepy_tpu.io.fits import read_fits
from rajepy_tpu.ops import pallas_kernels as pk
from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch.models.fields import static_fields_from_numpy
from rajepy_tpu_torch.ops import kernels as kn
from tests.torch_one_thread import one_thread  # noqa: F401

YEAR = 31536000.0
FREQS = np.array([3e8, 6e9, 2.2e10, 3e11])


@pytest.fixture()
def forced_interpret():
    pk.force_interpret(True)
    try:
        yield
    finally:
        pk.force_interpret(False)


def _pair(params, inc=None, pa=None, n=None, jax_dtype=jnp.float64,
          dtype='parity', t_yr=2.0):
    p = copy.deepcopy(params)
    if n is not None:
        p['grid'].update(n_x=n[0], n_y=n[1], n_z=n[2], l_z=None)
    if inc is not None:
        p['geometry'].update(inc=inc, pa=pa)
    jm_j = JaxJetModel(copy.deepcopy(p), dtype=jax_dtype)
    jm_t = JetModel(copy.deepcopy(p), dtype=dtype, device='cpu')
    jm_j.time = jm_t.time = t_yr * YEAR
    return jm_j, jm_t


def _rel(got, want):
    got = np.nan_to_num(np.asarray(got, dtype=float))
    want = np.nan_to_num(np.asarray(want, dtype=float))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    return np.max(np.abs(got - want)) / scale


def _products(jm):
    return {
        'flux_ff': jm.flux_ff(FREQS),
        'flux_ff scalar': jm.flux_ff(6e9),
        'emission_measure': jm.emission_measure(),
        'optical_depth_ff': jm.optical_depth_ff(FREQS),
        'optical_depth_ff cube': jm.optical_depth_ff(FREQS[:2],
                                                     collapse=False),
        'intensity_ff': jm.intensity_ff(FREQS),
    }


@pytest.mark.parametrize("which", ["model_params", "disc_wind_params"])
def test_continuum_products_match_jax_f64(request, which):
    """q_T = 0 (van Hoof gaunt) and the disc wind (Reynolds gaunt)."""
    jm_j, jm_t = _pair(request.getfixturevalue(which))
    assert jm_t.dtype == torch.float64 and not jm_t._use_tiles()
    want, got = _products(jm_j), _products(jm_t)
    for name in want:
        err = _rel(got[name], want[name])
        assert err < 1e-9, f"{name}: rel err {err:.2e}"
    em, taus, fluxes = jm_t.continuum_rt_products(FREQS)
    em_j, taus_j, fluxes_j = jm_j.continuum_rt_products(FREQS)
    for name, g, w in (('em', em, em_j), ('taus', taus, taus_j),
                       ('fluxes', fluxes, fluxes_j)):
        err = _rel(g, w)
        assert err < 1e-9, f"continuum_rt_products {name}: {err:.2e}"


def test_rt_from_jax_fields_matches_jax_f64(model_params):
    """RT alone: the port fed the JAX package's own fields."""
    jm_j, jm_t = _pair(model_params, t_yr=0.6)
    jm_t._fields = static_fields_from_numpy(jm_j._ensure_fields(), 'cpu',
                                            torch.float64)
    for name, got, want in (
            ('flux_ff', jm_t.flux_ff(FREQS), jm_j.flux_ff(FREQS)),
            ('em', jm_t.emission_measure(), jm_j.emission_measure())):
        err = _rel(got, want)
        assert err < 1e-9, f"{name}: rel err {err:.2e}"


@pytest.mark.parametrize("inc,pa", [(90.0, 0.0), (55.0, 30.0)])
def test_f32_tile_path_matches_jax(forced_interpret, model_params, inc, pa):
    n = (24, 48, 24)
    jm_j32, jm_t32 = _pair(model_params, inc, pa, n, jnp.float32,
                           torch.float32, t_yr=2.2)
    jm_j64, _ = _pair(model_params, inc, pa, n, t_yr=2.2)
    assert jm_t32._use_tiles()
    st = jm_t32._rt_static()
    assert st.seg is not None, "compaction must be live at f32 with bursts"
    assert st.a_t.shape[1:] == kn.TILE
    if (inc, pa) != (90.0, 0.0):
        assert jm_t32._ts_pack_offset > 1.0     # negative ts present
    assert jm_j32._rt_static().seg is not None
    # the f32 travel times of the two fills differ in their last bits
    assert jm_t32._ts_pack_offset == pytest.approx(jm_j32._ts_pack_offset,
                                                   rel=1e-5)
    freqs = np.array([6e9, 2.2e10])
    for name, got, j32, j64 in [
        ('flux_ff', jm_t32.flux_ff(freqs), jm_j32.flux_ff(freqs),
         jm_j64.flux_ff(freqs)),
        ('em', jm_t32.emission_measure(), jm_j32.emission_measure(),
         jm_j64.emission_measure()),
        ('tau', jm_t32.optical_depth_ff(freqs), jm_j32.optical_depth_ff(freqs),
         jm_j64.optical_depth_ff(freqs)),
    ]:
        assert got.dtype == np.float32
        assert _rel(got, j32) < 2e-4, f"{name} vs JAX f32 interpret"
        assert _rel(got, j64) < 2e-4, f"{name} vs JAX f64 oracle"
    em, taus, fluxes = jm_t32.continuum_rt_products(freqs)
    np.testing.assert_allclose(em, jm_t32.emission_measure(), rtol=1e-6)
    np.testing.assert_allclose(taus, jm_t32.optical_depth_ff(freqs),
                               rtol=1e-6)
    np.testing.assert_allclose(fluxes, jm_t32.flux_ff(freqs), rtol=1e-6)


def test_f32_full_grid_branch_when_no_tile_is_active(forced_interpret,
                                                     model_params):
    """A grid inside the launch radius holds no jet cell: the f32 burst
    path takes the full-grid kernel branch, as the JAX package does."""
    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=8, n_y=16, n_z=8, c_size=0.01)
    jm_j, jm_t = (JaxJetModel(copy.deepcopy(p), dtype=jnp.float32),
                  JetModel(copy.deepcopy(p), dtype=torch.float32,
                           device='cpu'))
    jm_j.time = jm_t.time = 2.0 * YEAR
    assert jm_t._rt_static().seg is None and jm_j._rt_static().seg is None
    em = jm_t.emission_measure()
    np.testing.assert_array_equal(em, np.asarray(jm_j.emission_measure()))
    assert em.shape == (8, 8) and not em.any()
    _, taus, fluxes = jm_t.continuum_rt_products(FREQS)
    assert taus.shape == fluxes.shape == (4, 8, 8) and not fluxes.any()


def _wcs(hdr):
    keys = ['NAXIS', 'BUNIT', 'OBJECT', 'EQUINOX'] + [
        f'{k}{i}' for k in ('NAXIS', 'CTYPE', 'CRPIX', 'CRVAL', 'CDELT')
        for i in (1, 2, 3, 4)] + ['RESTFRQ']
    return {k: hdr[k] for k in keys if k in hdr}


def test_save_fits_matches_jax(tmp_path, model_params):
    jm_j, jm_t = _pair(model_params)
    cases = [
        ('flux', lambda jm, f: jm.flux_ff(FREQS, savefits=f)),
        ('flux1', lambda jm, f: jm.flux_ff(6e9, savefits=f)),
        ('em', lambda jm, f: jm.emission_measure(savefits=f)),
        ('tau', lambda jm, f: jm.optical_depth_ff(FREQS, savefits=f)),
        ('taucube', lambda jm, f: jm.optical_depth_ff(6e9, savefits=f,
                                                      collapse=False)),
        ('int', lambda jm, f: jm.intensity_ff(FREQS[:2], savefits=f)),
    ]
    for name, call in cases:
        fj = str(tmp_path / f'{name}_jax.fits')
        ft = str(tmp_path / f'{name}_torch.fits')
        call(jm_j, fj)
        call(jm_t, ft)
        dj, hj = read_fits(fj)
        dt, ht = read_fits(ft)
        assert dt.shape == dj.shape, name
        assert _rel(dt, dj) < 1e-9, name
        assert _wcs(ht) == _wcs(hj), name
        assert ht['AUTHOR'] == 'rajepy_tpu_torch'


def test_checkpoints_load_in_both_packages(tmp_path, model_params):
    jm_j, jm_t = _pair(model_params, t_yr=2.2)
    want = jm_j.flux_ff(FREQS)
    jm_t.flux_ff(FREQS)
    pt, pj = str(tmp_path / 'torch.pkl'), str(tmp_path / 'jax.pkl')
    jm_t.save(pt)
    jm_j.save(pj)
    with open(pt, 'rb') as f:
        raw = pickle.load(f)
    assert set(raw) == {'params', 'areas', 'ffs', 'time', 'log'}
    assert raw['log'] is None and raw['time'] == 2.2 * YEAR

    # the port's checkpoint in the JAX package, and the reverse
    from_t = JaxJetModel.load_model(pt)
    from_j = JetModel.load_model(pj, dtype='parity', device='cpu')
    assert from_t.time == from_j.time == 2.2 * YEAR
    for jm in (from_t, from_j):
        err = _rel(jm.flux_ff(FREQS), want)
        assert err < 1e-9
    np.testing.assert_array_equal(from_j.fill_factor,
                                  np.asarray(jm_j.fill_factor))
    np.testing.assert_array_equal(from_t.areas, jm_t.areas)


def test_dtype_and_device_policy(model_params, monkeypatch):
    p = copy.deepcopy(model_params)
    assert JetModel(copy.deepcopy(p), device='cpu').dtype == torch.float64
    assert JetModel.resolve_dtype('auto', 'cuda') == torch.float32
    assert JetModel.resolve_dtype('parity', 'cuda') == torch.float64
    with pytest.raises(ValueError):
        JetModel.resolve_dtype('float16', 'cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        JetModel(copy.deepcopy(p))
    with pytest.raises(RuntimeError, match='CUDA'):
        JetModel(copy.deepcopy(p), device='cuda')
