"""The port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
plain versions of the epoch kernels are held against the Pallas kernels run
in the interpreter (the only difference is the order of the f32 sums:
1e-5 relative); the tile compaction must match exactly.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rajepy_tpu.ops import gaunt as jgaunt
from rajepy_tpu.ops import hyp2f1 as jhyp
from rajepy_tpu.ops import pallas_kernels as pk
from rajepy_tpu.models import grid as jgrid
from rajepy_tpu_torch.ops import gaunt as tgaunt
from rajepy_tpu_torch.ops import hyp2f1 as thyp
from rajepy_tpu_torch.ops import kernels as kn
from rajepy_tpu_torch.models import grid as tgrid
from tests.torch_one_thread import one_thread  # noqa: F401

YEAR = 31536000.0
BURSTS = ((0.5 * YEAR, 1.0 / (2.0 * (0.13 * YEAR) ** 2), 4.0, True),
          (0.75 * YEAR, 1.0 / (2.0 * (0.13 * YEAR) ** 2), 4.0, False),
          (1.0 * YEAR, 1.0 / (2.0 * (0.38 * YEAR) ** 2), 1.5, False),
          (2.0 * YEAR, 1.0 / (2.0 * (0.42 * YEAR) ** 2), 9.0, True),
          (2.0 * YEAR, 1.0 / (2.0 * (0.42 * YEAR) ** 2), 9.0, False))


@pytest.mark.parametrize("a,c", [(0.4, 2.3), (-0.3, 1.75), (0.4, 2.942),
                                 (-2.0, 1.5), (0.0, 2.0)])
def test_hyp2f1_matches_jax_f64(a, c):
    """Direct series and connection branch, the disc-wind exponents of
    the fields tests (0.4, 2.942), a terminating series (a = -2) and the
    trivial a = 0."""
    u = np.linspace(0.0, 0.999, 401)
    want = np.asarray(jhyp.hyp2f1_a1_series(a, c, jnp.asarray(u)))
    got = thyp.hyp2f1_a1_series(a, c, torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_hyp2f1_integer_gap_nudge_matches_jax():
    """c - a - 1 = 1 is nudged by 1e-9, which makes the connection
    coefficients ~1e9 with opposite signs: both packages lose nine digits
    there (each is ~1e-7 from the exact value), so they agree to 1e-7."""
    u = np.linspace(0.0, 0.999, 401)
    want = np.asarray(jhyp.hyp2f1_a1_series(0.5, 2.5, jnp.asarray(u)))
    got = thyp.hyp2f1_a1_series(0.5, 2.5, torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    np.testing.assert_array_equal(got[u <= 0.8], want[u <= 0.8])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_launch_surface_is_exact(dtype):
    """rho is exactly 1 on the launch surface |r| = r_0, so the corner
    test there (w_0 * rho^eps against w = w_0) does not hang on the last
    bit of pow, whichever of PyTorch's CPU loops evaluates it."""
    from rajepy_tpu_torch.ops import geometry as geom
    mr0 = geom.mod_r_0(25.0, 7.0 / 9.0, 1.0)
    r = torch.tensor([-1.0] + [1.0] * 40, dtype=dtype)
    assert torch.all(geom.rho(r, 1.0, mr0) == 1.0)
    for n in (1, 7, 41):
        assert torch.all(geom.w_r(r[:n], 1.0, mr0, 1.0, 7.0 / 9.0) == 1.0)


def test_gff_matches_jax():
    freqs = np.geomspace(1e8, 1e12, 37)
    for temp in (3e3, 1e4, 2.5e4):
        want = np.asarray(jgaunt.gff(jnp.asarray(freqs), temp))
        got = tgaunt.gff(torch.as_tensor(freqs), temp).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("inc,pa", [(90.0, 0.0), (60.0, 30.0),
                                    (35.0, 120.0)])
def test_lz_to_grid_dims_matches_jax(model_params, inc, pa):
    p = dict(model_params)
    p['grid'] = dict(p['grid'], l_z=0.5)
    p['geometry'] = dict(p['geometry'], inc=inc, pa=pa, mod_r_0=3.509)
    assert tgrid.lz_to_grid_dims(p) == jgrid.lz_to_grid_dims(p)


def test_pack_launch_time_matches_jax():
    rng = np.random.default_rng(0)
    ts = rng.uniform(-3e5, 9e7, (6, 5, 7))
    red = rng.random(ts.shape) < 0.5
    off = kn.pack_offset_for(ts.min())
    assert off == pk.pack_offset_for(ts.min()) and off > 1.0
    want = np.asarray(pk.pack_launch_time(jnp.asarray(ts), jnp.asarray(red),
                                          jnp.float32, off))
    got = kn.pack_launch_time(torch.as_tensor(ts), torch.as_tensor(red),
                              torch.float32, off).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.abs(got) > 0)


def _inside(rng, shape):
    """Sparse jet mask: a few blobs, leaving most tiles empty."""
    inside = np.zeros(shape, bool)
    for _ in range(4):
        c = [rng.integers(0, n) for n in shape]
        sl = tuple(slice(max(ci - 3, 0), ci + 3) for ci in c)
        inside[sl] = True
    return inside


@pytest.mark.parametrize("shape", [(20, 130, 150), (16, 128, 256)])
def test_active_and_gather_tiles_match_jax(shape):
    rng = np.random.default_rng(1)
    inside = _inside(rng, shape)
    ids_j, seg_j = pk.active_tiles(jnp.asarray(inside), 8, 128, 64)
    ids_t, seg_t = kn.active_tiles(torch.as_tensor(inside), 8, 128, 64)
    assert ids_t.dtype == np.int32 and seg_t.dtype == np.int32
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    np.testing.assert_array_equal(seg_t, np.asarray(seg_j))
    assert 0 < ids_t.size
    cube = rng.random(shape).astype(np.float32)
    for fill in (0.0, 1.0):
        want = np.asarray(pk.gather_tiles(jnp.asarray(cube),
                                          jnp.asarray(ids_j), 8, 128, 64,
                                          fill))
        got = kn.gather_tiles(torch.as_tensor(cube), ids_t, 8, 128, 64,
                              fill)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(pk.gather_tiles(jnp.asarray(inside), jnp.asarray(ids_j),
                                      8, 128, 64, False))
    got = kn.gather_tiles(torch.as_tensor(inside), ids_t, 8, 128, 64, False)
    np.testing.assert_array_equal(got.numpy(), want)


def _random_epoch_inputs(rng, shape):
    """f32 base cube(s) with empty regions and packed launch times that
    include negative travel times."""
    a = rng.random(shape)
    b = rng.random(shape)
    a.reshape(shape[0], -1)[::3] = 0.0
    ts = rng.uniform(-0.05 * YEAR, 2.5 * YEAR, shape)
    ts.reshape(shape[0], -1)[1] = rng.uniform(-0.05 * YEAR, 0.0,
                                              ts[0].size)
    red = rng.random(shape) < 0.5
    off = kn.pack_offset_for(ts.min())
    tss = np.where(red, -(ts + off), ts + off)
    f32 = np.float32
    return a.astype(f32), b.astype(f32), tss.astype(f32), off


def _rel(got, want):
    got = np.asarray(got, float)
    want = np.asarray(want, float)
    assert want.max() > 0
    return np.max(np.abs(got - want)) / np.abs(want).max()


def test_plain_tile_kernels_match_pallas_interpret():
    rng = np.random.default_rng(2)
    n_act = 6
    a, b, tss, off = _random_epoch_inputs(rng, (n_act, 8, 64, 128))
    seg = np.array([0, 3, 0, 2, 1, 3], np.int32)
    nx, nz = 16, 200
    t = 2.1 * YEAR
    want = pk.epoch_base_map_tiles(jnp.asarray(a), jnp.asarray(tss),
                                   jnp.asarray(seg), t, BURSTS, nx, nz,
                                   interpret=True, pack_offset=off)
    seg_t = torch.as_tensor(seg, dtype=torch.int64)
    got = kn.epoch_base_map_tiles(torch.as_tensor(a), torch.as_tensor(tss),
                                  seg_t, t, BURSTS, nx, nz, off)
    assert got.shape == (nx, nz)
    assert _rel(got, want) < 1e-5
    wa, wb = pk.epoch_base_maps2_tiles(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(tss), jnp.asarray(seg), t,
                                       BURSTS, nx, nz, interpret=True,
                                       pack_offset=off)
    ga, gb = kn.epoch_base_maps2_tiles(torch.as_tensor(a),
                                       torch.as_tensor(b),
                                       torch.as_tensor(tss), seg_t, t,
                                       BURSTS, nx, nz, off)
    assert _rel(ga, wa) < 1e-5 and _rel(gb, wb) < 1e-5


def test_epoch_map_wrapper_with_a_walk_is_the_plain_version():
    """With the cached walk, as JetModel passes it, the single-base wrapper
    still takes CPU tensors to the plain version, which matches the Pallas
    kernel; segments of several tiles out of order, positions with no
    tile, ragged x and z."""
    rng = np.random.default_rng(5)
    n_act = 7
    a, _, tss, off = _random_epoch_inputs(rng, (n_act, 8, 64, 128))
    seg = np.array([5, 5, 0, 1, 5, 2, 2], np.int32)
    nx, nz = 21, 300
    t = 2.2 * YEAR
    want = pk.epoch_base_map_tiles(jnp.asarray(a), jnp.asarray(tss),
                                   jnp.asarray(seg), t, BURSTS, nx, nz,
                                   interpret=True, pack_offset=off)
    walk = tuple(torch.as_tensor(w) for w in kn.segment_order(seg, 3 * 3))
    seg_t = torch.as_tensor(seg, dtype=torch.int64)
    a_t, tss_t = torch.as_tensor(a), torch.as_tensor(tss)
    kn.reset_launches()
    got = kn.epoch_base_map_tiles(a_t, tss_t, seg_t, t, BURSTS, nx, nz, off,
                                  walk=walk)
    assert not any(kn.LAUNCHES.values())
    assert torch.equal(got, kn.epoch_base_map_tiles_plain(
        a_t, tss_t, seg_t, t, BURSTS, nx, nz, off))
    assert got.shape == (nx, nz)
    assert _rel(got, want) < 1e-5
    assert not got[8:16, :128].any() and not got[16:, 128:256].any()


def test_plain_full_kernel_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    a, _, tss, off = _random_epoch_inputs(rng, (20, 150, 140))
    t = 1.9 * YEAR
    want = pk.epoch_base_map_pallas(jnp.asarray(a), jnp.asarray(tss), t,
                                    BURSTS, interpret=True, pack_offset=off)
    got = kn.epoch_base_map_full(torch.as_tensor(a), torch.as_tensor(tss),
                                 t, BURSTS, off)
    assert got.shape == (20, 140)
    assert _rel(got, want) < 1e-5


def test_wrappers_take_cpu_tensors_to_the_plain_version_only():
    rng = np.random.default_rng(4)
    a, b, tss, off = _random_epoch_inputs(rng, (3, 8, 64, 128))
    a, b, tss = (torch.as_tensor(x) for x in (a, b, tss))
    seg = torch.tensor([0, 1, 0])
    kn.reset_launches()
    got = kn.epoch_base_map_tiles(a, tss, seg, 0.0, BURSTS, 16, 128, off)
    want = kn.epoch_base_map_tiles_plain(a, tss, seg, 0.0, BURSTS, 16, 128,
                                         off)
    assert torch.equal(got, want)
    ga, gb = kn.epoch_base_maps2_tiles(a, b, tss, seg, 0.0, BURSTS, 16, 128,
                                       off)
    wa, wb = kn.epoch_base_maps2_tiles_plain(a, b, tss, seg, 0.0, BURSTS, 16,
                                             128, off)
    assert torch.equal(ga, wa) and torch.equal(gb, wb)
    cube = a[0]
    assert torch.equal(kn.epoch_base_map_full(cube, tss[0], 0.0, BURSTS, off),
                       kn.epoch_base_map_full_plain(cube, tss[0], 0.0,
                                                    BURSTS, off))
    assert all(n == 0 for n in kn.LAUNCHES.values())
    meta = torch.empty((3, 8, 64, 128), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        kn.epoch_base_map_tiles(meta, meta, seg, 0.0, BURSTS, 16, 128, off)
    with pytest.raises(ValueError, match='at most 32 bursts'):
        kn._bursts_struct(BURSTS * 7)
