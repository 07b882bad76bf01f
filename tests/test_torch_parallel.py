"""The port's ``parallel.sharding`` against the JAX package's, on the CPU.

The JAX package runs on the session's 8-device virtual CPU mesh
(``tests/conftest.py``); the port on a mesh of 8 CPU shards, (n_chan,
n_los) = (2, 4), every shard on the one CPU device.  The small model is the
JAX tests' burst-free 16 x 32 x 16 jet (``tests/test_sharding.py``), in
float64 unless a case says otherwise.  Tolerances: 1e-12 relative where
only the order of a sum differs from the JAX package's or from the port's
single-device result; bit for bit against the port's single-device result
where the sharding does not reorder a sum (the grid fill, the epoch tiles,
the light curve, cube imaging); the cube against the JAX package's
``clean_cube`` within 1e-9 of each channel's peak, the parity contract of
``tests/test_torch_synthobs_cube.py``.
"""
import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import rajepy_tpu
import rajepy_tpu_torch
from rajepy_tpu.models import ejection as jej
from rajepy_tpu.ops import pallas_kernels as pk
from rajepy_tpu.ops import radtrans as jrt
from rajepy_tpu.parallel import sharding as jsh
from rajepy_tpu_torch.models import analysis as tana
from rajepy_tpu_torch.ops import kernels as kn
from rajepy_tpu_torch.ops import radtrans as trt
from rajepy_tpu_torch.parallel import sharding as tsh
from rajepy_tpu_torch.synthobs import imaging as timg, \
    observatories as tobs, uvgen as tuv
from tests.torch_one_thread import one_thread  # noqa: F401

CPU = torch.device('cpu')
YEAR = 31536000.0
SUM_RTOL = 1e-12


@pytest.fixture(scope='module')
def jax_mesh():
    if jax.device_count() < 8:
        pytest.skip("needs xla_force_host_platform_device_count=8")
    return jsh.make_mesh(n_los=4, n_chan=2)


@pytest.fixture(scope='module')
def mesh():
    return tsh.make_mesh(n_los=4, n_chan=2, devices=[CPU] * 8)


def _params(model_params, bursts=False):
    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=16, n_y=32, n_z=16, l_z=None)
    if not bursts:
        p['ejection'] = {'t_0': np.array([]), 'hl': np.array([]),
                         'chi': np.array([]), 'which': np.array([])}
    return p


def _models(model_params, bursts=False, dtype='parity'):
    p = _params(model_params, bursts)
    return (rajepy_tpu.JetModel(copy.deepcopy(p)),
            rajepy_tpu_torch.JetModel(copy.deepcopy(p), dtype=dtype,
                                      device='cpu'))


def _rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    return np.abs(got - want).max() / scale


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize('module', ['sharding', 'fanout'])
def test_every_public_name_of_the_jax_module(module):
    """Each function, class and constant that ``rajepy_tpu.parallel.<module>``
    defines (not what it imports) is in the port's module."""
    import importlib
    import types
    jmod = importlib.import_module(f'rajepy_tpu.parallel.{module}')
    tmod = importlib.import_module(f'rajepy_tpu_torch.parallel.{module}')
    public = {name for name, obj in vars(jmod).items()
              if not name.startswith('_') and (
                  isinstance(obj, (type, types.FunctionType)) and
                  obj.__module__ == jmod.__name__ or
                  isinstance(obj, (int, float, str)))}
    assert len(public) >= (15 if module == 'sharding' else 3)
    assert public <= set(dir(tmod)), sorted(public - set(dir(tmod)))
    assert tsh.LOS_AXIS == jsh.LOS_AXIS


def test_make_mesh_and_layouts(mesh):
    assert mesh.axis_names == ('chan', 'los')
    assert mesh.devices.shape == (2, 4) and mesh.size == 8
    assert mesh.shape == {'chan': 2, 'los': 4}
    assert all(d == CPU for d in mesh.devices.ravel())
    # by default: every device of the CPU, all on the LOS axis
    assert tsh.available_devices('cpu') == [CPU]
    assert tsh.make_mesh(devices=[CPU] * 8).devices.shape == (1, 8)
    with pytest.raises(ValueError, match='needs 8 devices'):
        tsh.make_mesh(n_los=4, n_chan=2, devices=[CPU] * 4)
    assert tsh.grid_sharding(mesh).dim == trt.LOS_AXIS
    assert tsh.chan_sharding(mesh).axis == tsh.map_sharding(mesh).axis == \
        'chan'


def test_shard_fields_and_put(model_params, mesh):
    _, tm = _models(model_params)
    f = tm._ensure_fields()
    fs = tsh.shard_fields(f, mesh)
    for name in f._fields:
        part = getattr(fs, name)
        assert [p.shape for p in part.parts] == [(16, 8, 16)] * 4, name
        assert torch.equal(part.gather(), getattr(f, name)), name
        assert np.array_equal(np.asarray(part), getattr(f, name).numpy())
    freqs = tsh.put(torch.arange(5.0), tsh.chan_sharding(mesh))
    assert [p.tolist() for p in freqs.parts] == [[0, 1, 2], [3, 4]]
    with pytest.raises(ValueError, match='does not tile'):
        tsh.put(torch.zeros(16, 30, 16), tsh.grid_sharding(mesh))


def test_sharded_static_fields(model_params, jax_mesh, mesh):
    """Each LOS slab's fill is the whole fill's rows bit for bit, and the
    JAX package's sharded fill within 1e-12."""
    jm, tm = _models(model_params)
    args = (tm._static_params(), tm._ss_jml_rb_frac, tm.nx, tm.ny, tm.nz,
            tm.csize)
    shard = tsh.sharded_static_fields(mesh, *args, with_time=False)
    with jax_mesh:
        want = jsh.sharded_static_fields(
            jax_mesh, jm._static_params(), jm._ss_jml_rb_frac, jm.nx, jm.ny,
            jm.nz, jm.csize, dtype=jnp.float64, with_time=False)
    single = tm._ensure_fields()
    for name in single._fields:
        got = getattr(shard, name)
        assert [p.shape for p in got.parts] == [(16, 8, 16)] * 4, name
        assert torch.equal(got.gather(), getattr(single, name)), name
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(getattr(want, name)),
                                   rtol=SUM_RTOL, atol=0, err_msg=name)
    with pytest.raises(ValueError, match='does not tile'):
        tsh.sharded_static_fields(mesh, *args[:3], 30, *args[4:])


def test_fill_memory_stats(model_params, jax_mesh, mesh):
    """The JAX package's keys; the bytes of the shapes, and no measured
    per-device bytes on the CPU, which reports none."""
    jm, tm = _models(model_params)
    got = tsh.fill_memory_stats(mesh, tm._static_params(),
                                tm._ss_jml_rb_frac, tm.nx, tm.ny, tm.nz,
                                tm.csize)
    want = jsh.fill_memory_stats(jax_mesh, jm._static_params(),
                                 jm._ss_jml_rb_frac, jm.nx, jm.ny, jm.nz,
                                 jm.csize, dtype=jnp.float64,
                                 with_time=jm._has_bursts)
    assert set(got) == set(want)
    assert got['per_device_bytes'] is None
    for key in ('full_output_bytes', 'min_leaf_bytes', 'n_los'):
        assert got[key] == want[key], key
    assert got['per_device_output_bytes'] == got['full_output_bytes'] // 4


def test_sharded_continuum_step(model_params, jax_mesh, mesh):
    jm, tm = _models(model_params)
    freqs = np.array([1e9, 3e9, 6e9, 1e10, 2e10])
    t_0 = tm.params['properties']['T_0']
    f, n_es, ds = tm._rt_inputs()
    got = tsh.sharded_continuum_step(mesh, t_0, False)(
        _t(freqs), f.temp, n_es, ds, f.inside)
    assert [p.shape[0] for p in got.parts] == [3, 2]
    single = trt.tau_ff_maps(_t(freqs), f.temp, n_es, ds, f.inside, t_0,
                             False)
    assert _rel(got, single) < SUM_RTOL
    fj, n_es_j, ds_j = jm._rt_inputs()
    with jax_mesh:
        fs = jsh.shard_fields(fj, jax_mesh)
        grid = jsh.grid_sharding(jax_mesh)
        want = jsh.sharded_continuum_step(jax_mesh, t_0, False)(
            jnp.asarray(freqs[:4]), fs.temp, jax.device_put(n_es_j, grid),
            jax.device_put(ds_j, grid), fs.inside)
    assert _rel(np.asarray(got)[:4], want) < SUM_RTOL


@pytest.mark.parametrize('slabs', [False, True])
def test_sharded_rt_products(model_params, jax_mesh, mesh, slabs):
    """Whole cubes or LOS slabs in: the EM map, tau and flux maps against
    the JAX package's sharded step and the port's single-device API."""
    jm, tm = _models(model_params)
    freqs = np.array([6e9, 1e10])
    t_0, dist = tm.params['properties']['T_0'], tm.params['target']['dist']
    f = tm._ensure_fields()
    if slabs:
        f = tsh.shard_fields(f, mesh)
    em, taus, fluxes = tsh.sharded_rt_products(
        mesh, t_0, False, tm.csize, dist)(_t(freqs), f.nd, f.xi, f.temp,
                                          f.ff, f.area, f.inside)
    assert isinstance(em, torch.Tensor) and em.shape == (16, 16)
    assert [p.shape for p in fluxes.parts] == [(1, 16, 16)] * 2
    assert _rel(em, tm.emission_measure()) < SUM_RTOL
    assert _rel(taus, tm.optical_depth_ff(freqs)) < SUM_RTOL
    assert _rel(fluxes, tm.flux_ff(freqs)) < SUM_RTOL
    fj = jm._ensure_fields()
    with jax_mesh:
        fs = jsh.shard_fields(fj, jax_mesh)
        want = jsh.sharded_rt_products(jax_mesh, t_0, False, jm.csize,
                                       dist)(
            jax.device_put(jnp.asarray(freqs),
                           jsh.chan_sharding(jax_mesh)),
            fs.nd, fs.xi, fs.temp, fs.ff, fs.area, fs.inside)
    for g, w in zip((em, taus, fluxes), want):
        assert _rel(g, w) < SUM_RTOL


def test_sharded_rt_products_mean_temperature_is_not_a_mean_of_means(
        model_params, mesh):
    """The LOS-mean temperature sums the slabs' numerators and counts: a
    column whose slabs hold different numbers of jet cells gives the
    whole column's mean (a mean of the slabs' means would not)."""
    temp = torch.zeros(1, 8, 1, dtype=torch.float64)
    inside = torch.zeros(1, 8, 1, dtype=torch.bool)
    temp[0, :3, 0] = torch.tensor([1e4, 2e4, 3e4])   # slab 0: 2, slab 1: 1
    inside[0, :3, 0] = True
    ones = torch.where(inside, 1.0, 0.0).to(torch.float64)
    freqs = torch.tensor([1e9], dtype=torch.float64)
    _, _, fluxes = tsh.sharded_rt_products(mesh, 1e4, True, 0.5, 120.)(
        freqs, ones * 1e5, ones, temp, ones, ones, inside)
    want = trt.flux_ff_maps(
        freqs,
        trt.tau_ff_maps(freqs, temp, ones * 1e5,
                        trt.path_length_cm(ones, ones, 0.5), inside, 1e4,
                        True),
        *trt.mean_temperature_map(temp, inside), 0.5, 120.)
    assert _rel(fluxes, want) < SUM_RTOL


def test_sharded_rrl_tau_maps(model_params, jax_mesh, mesh):
    jm, tm = _models(model_params)
    coeffs = trt.RRLCoeffs('H58a')
    freqs = np.linspace(coeffs.nu0 * 0.9999, coeffs.nu0 * 1.0001, 5)
    f, n_es, ds = tm._rt_inputs()
    got = tsh.sharded_rrl_tau_maps(mesh, coeffs, _t(freqs), f.temp, n_es,
                                   f.vy, ds, f.inside)
    assert [p.shape[0] for p in got.parts] == [3, 2]
    single = trt.tau_rrl_maps(coeffs, _t(freqs), f.temp, n_es, f.vy, ds,
                              f.inside)
    assert _rel(got, single) < SUM_RTOL
    fj, n_es_j, ds_j = jm._rt_inputs()
    with jax_mesh:
        fs = jsh.shard_fields(fj, jax_mesh)
        grid = jsh.grid_sharding(jax_mesh)
        want = jsh.sharded_rrl_tau_maps(
            jax_mesh, jrt.RRLCoeffs('H58a'),
            jax.device_put(jnp.asarray(freqs[:4]),
                           jsh.chan_sharding(jax_mesh)), fs.temp,
            jax.device_put(n_es_j, grid), fs.vy,
            jax.device_put(ds_j, grid), fs.inside)
    assert _rel(np.asarray(got)[:4], want) < SUM_RTOL


@pytest.mark.parametrize('observer_near_y0', [False, True])
def test_sharded_transfer_scan(model_params, jax_mesh, mesh,
                               observer_near_y0):
    """The slabs' scans composed through the attenuation monoid: the
    whole cube's ordered scan and total opacity, and the JAX package's."""
    jm, tm = _models(model_params)
    t_0 = tm.params['properties']['T_0']
    f, n_es, ds = tm._rt_inputs()
    dtau = trt.tau_ff_cube(torch.tensor([1e10], dtype=torch.float64),
                           f.temp, n_es, ds, f.inside, t_0, False)[0]
    src = torch.where(f.inside, f.temp, torch.zeros_like(f.temp))
    inten, tau = tsh.sharded_transfer_scan(mesh, src, dtau,
                                           observer_near_y0)
    assert _rel(inten, trt.transfer_scan(src, dtau, observer_near_y0)) < \
        SUM_RTOL
    assert _rel(tau, dtau.sum(dim=1)) < SUM_RTOL
    sh = jsh.grid_sharding(jax_mesh)
    with jax_mesh:
        want_i, want_tau = jsh.sharded_transfer_scan(
            jax_mesh, jax.device_put(jnp.asarray(src.numpy()), sh),
            jax.device_put(jnp.asarray(dtau.numpy()), sh),
            observer_near_y0=observer_near_y0)
    assert _rel(inten, want_i) < SUM_RTOL
    assert _rel(tau, want_tau) < SUM_RTOL


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_sharded_epoch_base_map_tiles(model_params, jax_mesh, mesh, dtype):
    """The tile positions split over the 8 shards: the single-device map
    bit for bit; in float64, the JAX package's sharded tiles and the
    full-grid chi^2 LOS sum within 1e-12."""
    jm, tm = _models(model_params, bursts=True,
                     dtype=getattr(torch, dtype))
    st = tm._rt_static()
    t_now = 1.1 * YEAR
    bursts, off = tm._burst_tuple(), tm._ts_pack_offset
    if dtype == 'float32':
        args = (st.a_t, st.tss_t, st.seg)
        walk = st.walk
    else:   # the float64 model keeps no tiles: cut them here
        ids, seg = kn.active_tiles(tm._ensure_fields().inside)
        args = (kn.gather_tiles(st.a, ids),
                kn.gather_tiles(st.ts_signed, ids, fill=1.0),
                torch.as_tensor(seg, dtype=torch.int64))
        walk = None
    got = tsh.sharded_epoch_base_map_tiles(mesh, *args, t_now, bursts,
                                           tm.nx, tm.nz, off, walk=walk)
    single = kn.epoch_base_map_tiles(*args, t_now, bursts, tm.nx, tm.nz,
                                     off, walk=walk)
    assert torch.equal(got, single)
    if dtype == 'float32':
        return
    f = tm._ensure_fields()
    chi = tm._chi2(f, t_now)
    assert _rel(got, torch.sum(st.a * chi, dim=1)) < SUM_RTOL
    fj, stj = jm._ensure_fields(), jm._rt_static()
    tile = dict(block_x=8, block_z=128, y_chunk=16)
    ids, seg = pk.active_tiles(fj.inside, **tile)
    want = jsh.sharded_epoch_base_map_tiles(
        jax_mesh, pk.gather_tiles(stj.a, jnp.asarray(ids), **tile),
        pk.gather_tiles(stj.ts_signed, jnp.asarray(ids), fill=1.0, **tile),
        jnp.asarray(seg), t_now, jm._spec_r, jm._spec_b, jm.nx, jm.nz,
        pack_offset=jm._ts_pack_offset)
    assert _rel(got, want) < SUM_RTOL
    chi_j = jej.chi_field(fj.red, t_now - fj.ts, jm._spec_r, jm._spec_b)
    assert _rel(want, jnp.sum(stj.a * chi_j * chi_j, axis=1)) < SUM_RTOL


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_light_curve_sharded(model_params, jax_mesh, mesh, dtype):
    """11 epochs over 8 shards: ``light_curve`` bit for bit, and in
    float64 the JAX package's sharded light curve within 1e-12."""
    jm, tm = _models(model_params, bursts=True,
                     dtype=getattr(torch, dtype))
    times = np.linspace(0.0, 1.2, 11)
    freqs = np.array([6e9, 1e10])
    got = tsh.light_curve_sharded(tm, times, freqs, mesh)
    assert got.shape == (11, 2)
    np.testing.assert_array_equal(got, tana.light_curve(tm, times, freqs))
    if dtype == 'float64':
        want = jsh.light_curve_sharded(jm, times, freqs)
        assert _rel(got, want) < SUM_RTOL


def _cube_inputs(n_chan=7, n_pix=64, seed=5):
    """tests/test_torch_synthobs_cube.py's cube: six VLA A antennas, two
    hours at 60 s, a point source off centre and one on it, noise."""
    rng = np.random.default_rng(seed)
    xyz = tobs.read_antenna_config(tobs.cfg_file('VLA', 'A'))['xyz'][:6]
    bl, _ = tuv.baselines(xyz)
    uvw = tuv.uvw_tracks(bl, tuv.scan_hour_angles(0.0, 7200., 60.),
                         18.13, -107.6).reshape(-1, 3)
    freqs = 3.285e10 + 1e5 * (np.arange(n_chan) - n_chan // 2)
    lam = 299792458.0 / freqs
    cell = 0.4 / (np.abs(uvw[:, :2]).max() / lam.min())
    vis = np.empty((n_chan, uvw.shape[0]), complex)
    for c in range(n_chan):
        u, v = uvw[:, 0] / lam[c], uvw[:, 1] / lam[c]
        vis[c] = (1.0 + 0.3 * c) * np.exp(-2j * np.pi * (
            u * 6 * cell - v * 4 * cell)) + 0.5
        vis[c] += rng.normal(0, 0.3, vis.shape[1]) + \
            1j * rng.normal(0, 0.3, vis.shape[1])
    weights = rng.uniform(0.5, 1.0, uvw.shape[0])
    mask = np.zeros((n_pix, n_pix))
    mask[16:48, 16:48] = 1.0
    kern = timg.gaussian_beam_kernel(n_pix, cell, 3 * cell, 2 * cell, 20.0)
    return uvw, freqs, vis, weights, n_pix, cell, mask, kern


def test_sharded_clean_cube(jax_mesh):
    """7 channels over a (4, 2) mesh (blocks of 2, 2, 2, 1): the unsharded
    ``clean_cube`` bit for bit with the shards' counts merged, and the
    JAX package's sharded cube within 1e-9 of each channel's peak."""
    uvw, freqs, vis, w, n_pix, cell, mask, kern = _cube_inputs()
    kw = dict(weighting='natural', niter=60, nsigma=2.0)
    mesh = tsh.make_mesh(n_los=2, n_chan=4, devices=[CPU] * 8)
    info, info1 = {}, {}
    rest, dirty = tsh.sharded_clean_cube(mesh, uvw, freqs, _t(vis), w,
                                         n_pix, cell, mask, kern, info=info,
                                         **kw)
    assert [p.shape[0] for p in rest.parts] == [2, 2, 2, 1]
    rest1, dirty1 = timg.clean_cube(uvw, freqs, _t(vis), w, n_pix, cell,
                                    mask, kern, info=info1, **kw)
    assert torch.equal(rest.gather(), rest1)
    assert torch.equal(dirty.gather(), dirty1)
    assert info['n_blocks'] == 4 and info['chan_block'] == 2
    for key in ('iterations', 'channel_iterations'):
        assert info[key] == info1[key], key
    with jax_mesh:
        want, _ = jsh.sharded_clean_cube(
            jax_mesh, uvw, freqs, vis.real, vis.imag, w, n_pix, cell, mask,
            kern, **kw)
    want = np.asarray(want)
    for c in range(len(freqs)):
        assert np.abs(rest1[c].numpy() - want[c]).max() < \
            1e-9 * np.abs(dirty1[c].numpy()).max(), c
