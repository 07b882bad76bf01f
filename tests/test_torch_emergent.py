"""The port's emergent slice against the JAX package's, on the CPU.

* the new half of ``ops/radtrans`` (``transfer_scan``, ``cumulative_tau``,
  ``tau_ff_cube``, ``tau_ff_maps_from_static``, ``emission_measure_map``)
  at float64 to 1e-12 of the map maximum, both observer orientations;
* ``active_tiles_scan_order`` equal to the JAX function's, and
  ``scatter_tile_maps`` likewise;
* the plain versions of the emergent kernels against ``transfer_scan_pallas``
  / ``emergent_ff_pallas`` / ``emergent_ff_tiles`` in the Pallas
  interpreter to 1e-5 of the map maximum (ragged grids, zero-opacity y
  ranges, both orientations, with and without bursts, negative travel
  times), and against the float64 host oracle of bench.py to 1e-5;
* ``JetModel.emergent_intensity_ff``: float64 to 1e-9 of the JAX package's
  (the continuum parity contract of docs/MIGRATION.md), the isothermal-slab
  identity to 1e-9, the float32 tile path to 1e-4 of JAX's float32
  interpret path and 3e-3 of its float64 model, on axis and at
  inc=55/pa=30 where travel times go negative, and a jet-free grid through
  the full-grid branch.

Inputs are made with numpy from a seed and handed to both packages.
"""
import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rajepy_tpu import JetModel as JaxJetModel
from rajepy_tpu import constants as jcnsts
from rajepy_tpu.models import ejection as jej
from rajepy_tpu.ops import pallas_kernels as pk
from rajepy_tpu.ops import radtrans as jrt
from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch.ops import kernels as kn
from rajepy_tpu_torch.ops import physics as tphys
from rajepy_tpu_torch.ops import radtrans as trt
from tests.torch_one_thread import one_thread  # noqa: F401

YEAR = 31536000.0
F32 = np.float32


@pytest.fixture()
def forced_interpret():
    pk.force_interpret(True)
    try:
        yield
    finally:
        pk.force_interpret(False)


def _rel(got, want):
    got = np.asarray(got, dtype=float)
    want = np.asarray(want, dtype=float)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    return np.max(np.abs(got - want)) / scale


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a)).to(dtype)


# --------------------------------------------------------------------------- #
# ops/radtrans
# --------------------------------------------------------------------------- #
def _jet_cube(seed, shape, frac=0.3):
    """Random jet fields as numpy: (inside, temp, n_es, ds), T = 1 and
    n_es = ds = 0 outside."""
    rng = np.random.default_rng(seed)
    inside = rng.random(shape) < frac
    temp = np.where(inside, 1e4 * (0.5 + rng.random(shape)), 1.0)
    n_es = np.where(inside, 1e7 * rng.random(shape), 0.0)
    ds = np.where(inside, 7.5e12, 0.0)
    return inside, temp, n_es, ds


@pytest.mark.parametrize("observer_near_y0", [False, True])
def test_radtrans_emergent_matches_jax_f64(observer_near_y0):
    rng = np.random.default_rng(0)
    shape = (5, 23, 7)
    src = rng.random(shape) * 1e-12
    dtau = 3.0 * rng.random(shape)
    dtau[:, :4] = 0.0                                # a transparent range
    got = trt.transfer_scan(_t(src), _t(dtau), observer_near_y0)
    want = jrt.transfer_scan(jnp.asarray(src), jnp.asarray(dtau),
                             observer_near_y0)
    assert _rel(got, want) < 1e-12
    assert _rel(trt.cumulative_tau(_t(dtau)),
                jrt.cumulative_tau(jnp.asarray(dtau))) < 1e-12

    inside, temp, n_es, ds = _jet_cube(1, shape, 0.6)
    fr = np.geomspace(3e8, 3e11, 4)
    for reyn in (True, False):
        got = trt.tau_ff_cube(_t(fr), _t(temp), _t(n_es), _t(ds),
                              torch.as_tensor(inside), 1e4, reyn)
        want = jrt.tau_ff_cube(jnp.asarray(fr), jnp.asarray(temp),
                               jnp.asarray(n_es), jnp.asarray(ds),
                               jnp.asarray(inside), 1e4, reyn)
        assert got.shape == (4,) + shape
        assert _rel(got, want) < 1e-12
        a = np.where(inside, rng.random(shape), 0.0)
        for chi2 in (1.0, 1.0 + rng.random(shape)):
            got = trt.tau_ff_maps_from_static(_t(fr), _t(a),
                                              chi2 if np.isscalar(chi2)
                                              else _t(chi2), 1e4, reyn)
            want = jrt.tau_ff_maps_from_static(jnp.asarray(fr),
                                               jnp.asarray(a),
                                               jnp.asarray(chi2), 1e4, reyn)
            assert _rel(got, want) < 1e-12
    xi = np.where(inside, rng.random(shape), 0.0)
    area = np.where(inside, rng.uniform(0.2, 1.0, shape), 0.0)
    ff = np.where(inside, rng.random(shape), 0.0)
    got = trt.emission_measure_map(_t(n_es), _t(xi), _t(ff), _t(area), 0.5)
    want = jrt.emission_measure_map(jnp.asarray(n_es), jnp.asarray(xi),
                                    jnp.asarray(ff), jnp.asarray(area), 0.5)
    assert _rel(got, want) < 1e-12


# --------------------------------------------------------------------------- #
# Compaction glue
# --------------------------------------------------------------------------- #
def _sparse_inside(seed, shape):
    """A sparse jet with inactive x tiles and an empty leading y range."""
    rng = np.random.default_rng(seed)
    inside = rng.random(shape) < 0.25
    inside[shape[0] // 2:] = False
    inside[:, : shape[1] // 4] = False
    return inside


@pytest.mark.parametrize("shape,tile", [
    ((16, 48, 130), dict(block_x=8, block_z=128, y_chunk=16)),
    ((37, 150, 200), dict(block_x=8, block_z=128, y_chunk=64)),
    ((8, 64, 128), dict(block_x=8, block_z=128, y_chunk=64)),
])
def test_active_tiles_scan_order_matches_jax(shape, tile):
    inside_f = np.flip(_sparse_inside(3, shape), 1).copy()
    got = kn.active_tiles_scan_order(torch.as_tensor(inside_f), **tile)
    want = pk.active_tiles_scan_order(jnp.asarray(inside_f), **tile)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
    ids, seg, it, kt = got
    assert ids.size > 0 and np.all(np.diff(seg) >= 0)
    starts = kn.segment_starts(seg, it.size)
    assert starts[0] == 0 and starts[-1] == ids.size
    np.testing.assert_array_equal(np.repeat(np.arange(it.size),
                                            np.diff(starts)), seg)


def test_scatter_tile_maps_matches_jax():
    rng = np.random.default_rng(6)
    parts = rng.random((3, 2, 8, 128)).astype(F32)
    it, kt = np.array([0, 1, 1], np.int32), np.array([1, 0, 1], np.int32)
    want = np.asarray(pk.scatter_tile_maps(jnp.asarray(parts),
                                           jnp.asarray(it), jnp.asarray(kt),
                                           2, 2, 16, 200))
    got = kn.scatter_tile_maps(torch.as_tensor(parts), it, kt, 2, 2, 16, 200)
    assert got.shape == (2, 16, 200)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:, :8, :128].any()               # no segment there


# --------------------------------------------------------------------------- #
# The emergent kernels' plain versions against the Pallas kernels
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("observer_near_y0", [False, True])
@pytest.mark.parametrize("shape", [(11, 40, 150), (8, 16, 130)])
def test_transfer_scan_plain_matches_pallas(shape, observer_near_y0):
    rng = np.random.default_rng(7)
    src = rng.random(shape).astype(F32)
    dtau = (0.2 * rng.random(shape)).astype(F32)
    dtau[:, 5:9] = 0.0                               # zero-opacity y range
    want_i, want_tau = pk.transfer_scan_pallas(
        jnp.asarray(src), jnp.asarray(dtau),
        observer_near_y0=observer_near_y0, interpret=True)
    got_i, got_tau = kn.transfer_scan_maps(torch.as_tensor(src),
                                           torch.as_tensor(dtau),
                                           observer_near_y0)
    assert got_i.dtype == torch.float32
    assert got_i.shape == got_tau.shape == (shape[0], shape[2])
    assert _rel(got_i, want_i) < 1e-5
    assert _rel(got_tau, want_tau) < 1e-5


def _emergent_inputs(seed, shape, freqs, reynolds_gaunt=True):
    """bench.py's recipe: float32 channel constants, safe temperature and
    frequency-independent opacity base, and the float32 opacity cube."""
    inside, temp, n_es, ds = _jet_cube(seed, shape)
    base = trt.tau_ff_base(_t(temp), _t(n_es), _t(ds),
                           torch.as_tensor(inside), reynolds_gaunt)
    scale = trt.tau_ff_channel_scale(_t(freqs), 1e4, reynolds_gaunt)
    cnu = 2.0 * jcnsts.H_CGS * freqs ** 3 / jcnsts.C_CGS ** 2
    hnuk = jcnsts.H_CGS * freqs / jcnsts.K_CGS
    f32 = torch.float32
    return dict(inside=inside, cnu=_t(cnu, f32), hnuk=_t(hnuk, f32),
                scale=scale.to(f32), temp=_t(temp, f32), base=base.to(f32))


def _oracle_f64(cnu, hnuk, temp, inside, dtau, observer_near_y0=False):
    """bench.py's float64 host oracle (bench.py:147-161): the ordered scan
    of the given opacity cube (n_chan, nx, ny, nz) in float64 with the
    exact blackbody source."""
    d64 = np.asarray(dtau, np.float64)
    cnu = np.asarray(cnu, np.float64)[:, None, None, None]
    hnuk = np.asarray(hnuk, np.float64)[:, None, None, None]
    s64 = np.where(inside[None], cnu / np.expm1(hnuk / np.asarray(
        temp, np.float64)[None]), 0.0)
    if not observer_near_y0:
        d64, s64 = d64[:, :, ::-1], s64[:, :, ::-1]
    taue = np.cumsum(d64, axis=2) - d64
    return np.sum(s64 * np.exp(-taue) * (-np.expm1(-d64)), axis=2)


@pytest.mark.parametrize("observer_near_y0", [False, True])
def test_emergent_full_plain_matches_pallas(observer_near_y0):
    freqs = np.linspace(1e9, 5e10, 5)
    d = _emergent_inputs(1, (12, 40, 130), freqs)
    d['base'][:, 8:24] = 0.0                        # zero-opacity y chunks
    args = (d['cnu'], d['hnuk'], d['scale'], d['temp'], d['base'])
    want_i, want_tau = pk.emergent_ff_pallas(
        *(jnp.asarray(a.numpy()) for a in args),
        observer_near_y0=observer_near_y0, y_chunk=8, interpret=True)
    got_i, got_tau = kn.emergent_ff_full(*args, observer_near_y0)
    assert got_i.shape == got_tau.shape == (5, 12, 130)
    assert _rel(got_i, want_i) < 1e-5
    assert _rel(got_tau, want_tau) < 1e-5


@pytest.mark.parametrize("reynolds_gaunt", [True, False])
def test_emergent_full_plain_matches_f64_oracle(reynolds_gaunt):
    freqs = np.linspace(1e9, 5e10, 6)
    d = _emergent_inputs(0, (16, 48, 128), freqs, reynolds_gaunt)
    got_i, got_tau = kn.emergent_ff_full(d['cnu'], d['hnuk'], d['scale'],
                                         d['temp'], d['base'])
    dtau = d['scale'][:, None, None, None] * d['base'][None]
    want = _oracle_f64(d['cnu'], d['hnuk'], d['temp'], d['inside'], dtau)
    assert _rel(got_i, want) < 1e-5
    assert _rel(got_tau, dtau.double().sum(2)) < 1e-5


def _bursts():
    spec_r = jej.EjectionSpec(1e-7, np.array([0.4 * 3.15e7]),
                              np.array([5e-7]), np.array([4.7e6]))
    spec_b = jej.EjectionSpec(2e-7, np.array([0.8 * 3.15e7]),
                              np.array([6e-7]), np.array([4.7e6]))
    out = []
    for spec, is_red in ((spec_r, True), (spec_b, False)):
        for t0, peak, sig in zip(spec.t_0, spec.peak_jml, spec.sigma):
            out.append((float(t0), float(1.0 / (2.0 * sig ** 2)),
                        float((peak - spec.ss_jml) / spec.ss_jml), is_red))
    return tuple(out), spec_r, spec_b


def _tile_case(with_bursts):
    """tests/test_pallas.py's recipe for the compacted ordered scan: a
    sparse jet (inactive x tiles, empty leading y range), negative travel
    times, y_chunk = 16, observer-ordered tiles."""
    nx, ny, nz = 16, 48, 130
    tile = dict(block_x=8, block_z=128, y_chunk=16)
    rng = np.random.default_rng(5)
    inside = _sparse_inside(5, (nx, ny, nz))
    temp = np.where(inside, 1e4 * (0.5 + rng.random(inside.shape)), 1.0)
    n_es = np.where(inside, 1e7 * rng.random(inside.shape), 0.0)
    ds = np.where(inside, 7.5e12, 0.0)
    ts = np.where(inside, 3e7 * rng.random(inside.shape) - 2e6, 0.0)
    red = rng.random(inside.shape) < 0.5
    freqs = np.linspace(1e9, 5e10, 4)
    bursts, spec_r, spec_b = _bursts()
    off = kn.pack_offset_for(ts.min())
    base = trt.tau_ff_base(_t(temp), _t(n_es), _t(ds),
                           torch.as_tensor(inside), True)
    tss = kn.pack_launch_time(_t(ts), torch.as_tensor(red), torch.float32,
                              off)
    ids, seg, it, kt = kn.active_tiles_scan_order(
        torch.flip(torch.as_tensor(inside), [1]), **tile)
    f32 = torch.float32

    def flipped(cube, fill=0.0):
        return kn.gather_tiles(torch.flip(cube, [1]).to(f32), ids,
                               fill=fill, **tile)

    return dict(
        nx=nx, nz=nz, tile=tile, inside=inside, temp=temp, ts=ts, red=red,
        freqs=freqs, bursts=bursts if with_bursts else (), specs=(spec_r,
                                                                  spec_b),
        off=off, t=0.9 * 3.15e7, base=base, ids=ids, seg=seg, it=it, kt=kt,
        scale=trt.tau_ff_channel_scale(_t(freqs), 1e4, True).to(f32),
        cnu=_t(2.0 * jcnsts.H_CGS * freqs ** 3 / jcnsts.C_CGS ** 2, f32),
        hnuk=_t(jcnsts.H_CGS * freqs / jcnsts.K_CGS, f32),
        temp_t=flipped(_t(temp), 1.0), a_t=flipped(base),
        tss_t=flipped(tss, 1.0))


def _plain_tile_maps(c):
    n_seg = int(c['seg'].max()) + 1
    inten, tau = kn.emergent_ff_tiles(
        c['cnu'], c['hnuk'], c['scale'], c['temp_t'], c['a_t'], c['tss_t'],
        torch.as_tensor(kn.segment_starts(c['seg'], n_seg)), c['it'],
        c['kt'], c['t'], c['bursts'], c['nx'], c['nz'], c['off'])
    return inten, tau


@pytest.mark.parametrize("with_bursts", [False, True])
def test_emergent_tiles_plain_matches_pallas(with_bursts):
    c = _tile_case(with_bursts)
    n_seg = int(c['seg'].max()) + 1
    assert n_seg < c['ids'].size                    # multi-tile segments
    parts, tau_parts = pk.emergent_ff_tiles(
        *(jnp.asarray(c[k].numpy()) for k in ('cnu', 'hnuk', 'scale',
                                              'temp_t', 'a_t', 'tss_t')),
        jnp.asarray(c['seg']), c['t'], c['bursts'], n_seg, interpret=True,
        pack_offset=c['off'])
    n_xt, n_zt = -(-c['nx'] // 8), -(-c['nz'] // 128)
    want_i, want_tau = (np.asarray(pk.scatter_tile_maps(
        p, jnp.asarray(c['it']), jnp.asarray(c['kt']), n_xt, n_zt, c['nx'],
        c['nz'])) for p in (parts, tau_parts))
    got_i, got_tau = _plain_tile_maps(c)
    assert got_i.shape == (4, c['nx'], c['nz'])
    assert _rel(got_i, want_i) < 1e-5
    assert _rel(got_tau, want_tau) < 1e-5


def test_emergent_tiles_plain_matches_f64_oracle():
    c = _tile_case(True)
    spec_r, spec_b = c['specs']
    chi = np.asarray(jej.chi_field(jnp.asarray(c['red']),
                                   c['t'] - jnp.asarray(c['ts']), spec_r,
                                   spec_b), np.float64)
    dtau = (c['scale'].double()[:, None, None, None] *
            (c['base'] * torch.as_tensor(chi * chi))[None])
    want = _oracle_f64(c['cnu'], c['hnuk'], c['temp'], c['inside'], dtau)
    got_i, got_tau = _plain_tile_maps(c)
    assert _rel(got_i, want) < 1e-5
    assert _rel(got_tau, dtau.sum(2)) < 1e-5


def test_emergent_wrappers_reject_other_devices():
    m = dict(device='meta')
    chan = [torch.zeros(2, **m) for _ in range(3)]
    with pytest.raises(ValueError, match='unsupported device'):
        kn.transfer_scan_maps(torch.zeros((2, 3, 4), **m),
                              torch.zeros((2, 3, 4), **m))
    with pytest.raises(ValueError, match='unsupported device'):
        kn.emergent_ff_full(*chan, torch.zeros((2, 3, 4), **m),
                            torch.zeros((2, 3, 4), **m))
    with pytest.raises(ValueError, match='unsupported device'):
        kn.emergent_tile_partials(
            *chan, *(torch.zeros((1,) + kn.TILE, **m) for _ in range(3)),
            torch.zeros(2, dtype=torch.int32, **m), 0.0, ())


# --------------------------------------------------------------------------- #
# JetModel
# --------------------------------------------------------------------------- #
_PAIRS = {}
FREQS = np.array([6e9, 2.2e10, 3e11])


def _no_bursts(p):
    p['ejection'] = {'t_0': np.array([]), 'hl': np.array([]),
                     'chi': np.array([]), 'which': np.array([])}
    return p


def _pair(params, inc=90.0, pa=0.0, jax_dtype=jnp.float64, dtype='parity',
          bursts=True, t_yr=2.2, n=None):
    """(JAX model, port model), cached per configuration so the JAX
    package's compiled programs are reused within this file."""
    key = (inc, pa, str(jax_dtype), str(dtype), bursts, t_yr, n)
    if key not in _PAIRS:
        p = copy.deepcopy(params)
        p['geometry'].update(inc=inc, pa=pa)
        if n is not None:
            p['grid'].update(n_x=n[0], n_y=n[1], n_z=n[2], l_z=None)
        if not bursts:
            _no_bursts(p)
        jm_j = JaxJetModel(copy.deepcopy(p), dtype=jax_dtype)
        jm_t = JetModel(copy.deepcopy(p), dtype=dtype, device='cpu')
        jm_j.time = jm_t.time = t_yr * YEAR
        _PAIRS[key] = (jm_j, jm_t)
    return _PAIRS[key]


@pytest.mark.parametrize("bursts", [True, False])
def test_emergent_intensity_ff_matches_jax_f64(model_params, bursts):
    jm_j, jm_t = _pair(model_params, bursts=bursts)
    assert not jm_t._use_fused_rrl()
    got = jm_t.emergent_intensity_ff(FREQS)
    want = jm_j.emergent_intensity_ff(FREQS)
    assert got.shape == (len(FREQS), jm_t.nx, jm_t.nz)
    assert got.dtype == np.float64
    assert _rel(got, want) < 1e-9
    got1 = jm_t.emergent_intensity_ff(2.2e10)       # a scalar: one map
    assert got1.shape == (jm_t.nx, jm_t.nz)
    assert _rel(got1, jm_j.emergent_intensity_ff(2.2e10)) < 1e-9
    np.testing.assert_allclose(got1, got[1], rtol=1e-12)


def test_emergent_reduces_to_slab_when_isothermal(model_params):
    """For an isothermal jet the ordered transfer integral equals the slab
    form B_nu(T)(1 - e^-tau) pixelwise (tests/test_model_api.py)."""
    p = _no_bursts(copy.deepcopy(model_params))
    p['grid'].update(n_x=16, n_y=40, n_z=16, l_z=None)
    jm = JetModel(p, dtype='parity', device='cpu')
    freq = 6e9
    ints = jm.emergent_intensity_ff(freq)
    tau = jm.optical_depth_ff(freq)
    t0 = jm.params['properties']['T_0']
    slab = float(tphys.blackbody_nu(_t(freq), _t(t0))) * \
        (-np.expm1(-tau)) * 1e-7 * 1e4
    assert ints.max() > 0
    np.testing.assert_allclose(ints, slab, rtol=1e-9, atol=1e-30)


@pytest.mark.parametrize("inc,pa", [(90.0, 0.0), (55.0, 30.0)])
def test_f32_emergent_tile_path_matches_jax(forced_interpret, model_params,
                                            inc, pa):
    jm_j32, jm_t32 = _pair(model_params, inc, pa, jnp.float32,
                           torch.float32)
    jm_j64, _ = _pair(model_params, inc, pa)
    assert jm_t32._use_fused_rrl() and jm_t32._emergent_tiles() is not None
    if (inc, pa) != (90.0, 0.0):
        assert jm_t32._ts_pack_offset > 1.0     # negative ts present
    got = jm_t32.emergent_intensity_ff(FREQS)
    assert got.dtype == np.float32
    assert _rel(got, jm_j32.emergent_intensity_ff(FREQS)) < 1e-4
    assert _rel(got, jm_j64.emergent_intensity_ff(FREQS)) < 3e-3


def test_f32_emergent_full_branch_when_no_tile_is_active(forced_interpret,
                                                         model_params):
    """A grid inside the launch radius holds no jet cell: the float32
    emergent path takes the full-grid (K7) branch, as the JAX package."""
    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=8, n_y=16, n_z=8, c_size=0.01)
    jm_j = JaxJetModel(copy.deepcopy(p), dtype=jnp.float32)
    jm_t = JetModel(copy.deepcopy(p), dtype=torch.float32, device='cpu')
    jm_j.time = jm_t.time = 2.0 * YEAR
    assert jm_t._emergent_tiles() is None
    calls = []
    full = kn.emergent_ff_full

    def spy(*args, **kwargs):
        calls.append(args[3].shape)
        return full(*args, **kwargs)

    kn.emergent_ff_full = spy
    try:
        got = jm_t.emergent_intensity_ff(FREQS)
    finally:
        kn.emergent_ff_full = full
    assert calls == [(8, 16, 8)]
    want = np.asarray(jm_j.emergent_intensity_ff(FREQS))
    assert got.shape == (len(FREQS), 8, 8)
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_emergent_tiles_cache_is_reset_with_the_fields(model_params):
    jm = JetModel(copy.deepcopy(model_params), dtype=torch.float32,
                  device='cpu')
    assert jm._emergent_tiles() is not None
    jm._inject_cached_ff(jm.fill_factor, jm.areas)
    assert jm._emergent_tiles_cache is None
