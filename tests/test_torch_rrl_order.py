"""The RRL maps kernels' host-side plumbing, on the CPU.

The CUDA kernels (csrc/rrl_maps.cu) cannot run here, so what they rely on
from the host is held here against the plain fold:

* ``segment_order``: the tile kernel walks segment s (the (x, z) tile
  position s // n_zt, s % n_zt) over tiles ``order[seg_start[s]] ..
  order[seg_start[s + 1] - 1]``; that walk, done here in numpy with the
  kernel's indexing, must give ``segment_tile_maps`` of the partials, on
  random tiles with empty ones and on the 32x80x32 conftest jet;
* ``tile_segments`` inverts it;
* ``rrl_row_activity_plain`` (the plain version of the full-grid kernel's
  first pass) flags exactly the (1, 64, 128) row blocks holding amp != 0;
* ``rrl_lanes_log2`` (the kernels' channel groups);
* the maps wrapper ``rrl_tiles`` against the Pallas kernel and its fold in
  the interpreter, at odd channel counts (1e-5).
"""
import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rajepy_tpu.ops import pallas_kernels as pk
from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch.ops import kernels as kn
from rajepy_tpu_torch.ops import radtrans as trt
from tests.torch_one_thread import one_thread  # noqa: F401

YEAR = 31536000.0
LINE = 'H58a'
NU0 = float(trt.RRLCoeffs(LINE).nu0)


def _walk_maps(parts, order, seg_start, nx, nz):
    """The tile kernel's indexing in numpy: segment s sums its tiles'
    partials into x rows (s // n_zt) * 8 + xr, z columns (s % n_zt) * 128
    + zl; padding rows and columns are dropped, positions with no tile
    stay 0."""
    n_act, n_chan, bx, bz = parts.shape
    n_zt = -(-nz // bz)
    out = np.zeros((n_chan, nx, nz), dtype=np.float64)
    for s in range(len(seg_start) - 1):
        x0, z0 = (s // n_zt) * bx, (s % n_zt) * bz
        for k in range(seg_start[s], seg_start[s + 1]):
            p = parts[order[k]]
            nxs, nzs = min(bx, nx - x0), min(bz, nz - z0)
            out[:, x0:x0 + nxs, z0:z0 + nzs] += p[:, :nxs, :nzs]
    return out


def _check_order(seg, order, seg_start, n_seg):
    assert order.dtype == np.int32 and seg_start.dtype == np.int32
    assert sorted(order.tolist()) == list(range(len(seg)))
    assert seg_start.shape == (n_seg + 1,)
    assert seg_start[0] == 0 and seg_start[-1] == len(seg)
    for s in range(n_seg):
        tiles = order[seg_start[s]:seg_start[s + 1]]
        assert np.all(np.asarray(seg)[tiles] == s)
        assert np.all(np.diff(tiles) > 0)      # compacted order kept


@pytest.mark.parametrize("n_act,nx,nz,seed", [
    (7, 24, 200, 0),        # 3 x 2 positions, two with no tile, ragged z
    (12, 37, 300, 1),       # ragged in x and z
    (1, 8, 128, 2),         # one tile, one position
    (0, 16, 128, 3),        # no tile at all
])
def test_segment_order_walk_matches_segment_tile_maps(n_act, nx, nz, seed):
    rng = np.random.default_rng(seed)
    n_xt, n_zt = -(-nx // 8), -(-nz // 128)
    n_seg = n_xt * n_zt
    # segments drawn from half the positions, in no order, with repeats
    seg = rng.choice(max(1, n_seg // 2), n_act).astype(np.int32) * 2 % n_seg
    parts = rng.random((n_act, 3, 8, 128)).astype(np.float32)
    parts[::4] = 0.0                                # empty tiles
    order, seg_start = kn.segment_order(seg, n_seg)
    _check_order(seg, order, seg_start, n_seg)
    want = kn.segment_tile_maps(torch.as_tensor(parts),
                                torch.as_tensor(seg, dtype=torch.int64),
                                nx, nz).numpy()
    got = _walk_maps(parts, order, seg_start, nx, nz)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    back = kn.tile_segments(torch.as_tensor(order),
                            torch.as_tensor(seg_start))
    np.testing.assert_array_equal(back.numpy(), seg)
    if n_act == 0:
        empty = torch.zeros((0,) + kn.TILE)
        maps = kn.rrl_tiles(torch.zeros(3), *(empty,) * 5, NU0,
                            torch.as_tensor(order),
                            torch.as_tensor(seg_start), nx, nz)
        assert maps.shape == (3, nx, nz) and not maps.any()


@pytest.mark.parametrize("inc", [90.0, 30.0])
def test_segment_order_walk_on_the_conftest_jet(model_params, inc):
    """At inc 30 the jet runs near the line of sight, so two y tiles lie
    on each of its (x, z) tile positions."""
    p = copy.deepcopy(model_params)
    p['geometry']['inc'] = inc
    jm = JetModel(p, dtype=torch.float32, device='cpu')
    jm.time = 2.0 * YEAR
    ids, seg = jm._active_tile_ids()
    temp_t, vy_t, ndxi_t, ds_t, inside_t, tss_t, order, seg_start = \
        jm._rrl_tiles()
    n_seg = -(-jm.nx // 8) * -(-jm.nz // 128)
    _check_order(seg, order.numpy(), seg_start.numpy(), n_seg)
    assert np.any(np.diff(seg_start.numpy()) > 1) == (inc == 30.0)
    freqs = jm._freqs(np.linspace(NU0 - 5e6, NU0 + 5e6, 5))
    n_es_t = ndxi_t * jm._chi_from_packed(tss_t, jm.time)
    args = trt.rrl_kernel_inputs(trt.RRLCoeffs(LINE), freqs, temp_t, n_es_t,
                                 vy_t, ds_t, inside_t)
    parts = kn.rrl_tile_partials(*args)
    want = kn.segment_tile_maps(parts, torch.as_tensor(seg, dtype=torch.int64),
                                jm.nx, jm.nz).numpy()
    assert want.max() > 0
    got = _walk_maps(parts.numpy(), order.numpy(), seg_start.numpy(), jm.nx,
                     jm.nz)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    maps = kn.rrl_tiles(*args, order, seg_start, jm.nx, jm.nz)
    np.testing.assert_array_equal(maps.numpy(), want)


@pytest.mark.parametrize("shape", [(37, 70, 150), (3, 128, 256), (5, 1, 1)])
def test_rrl_row_activity_plain(shape):
    rng = np.random.default_rng(7)
    amp = rng.random(shape).astype(np.float32)
    amp[rng.random(shape) < 0.97] = 0.0            # sparse jet cells
    amp[:1] = 0.0                                  # an empty x row
    amp[-1] = 1.0                                  # a wholly jet x row
    got = kn.rrl_row_activity(torch.as_tensor(amp)).numpy()
    nx, ny, nz = shape
    n_yc, n_zc = -(-ny // 64), -(-nz // 128)
    assert got.shape == (nx, n_yc, n_zc) and got.dtype == np.bool_
    for x in range(nx):
        for j in range(n_yc):
            for k in range(n_zc):
                blk = amp[x, j * 64:(j + 1) * 64, k * 128:(k + 1) * 128]
                assert got[x, j, k] == bool(np.any(blk != 0))
    assert not got[0].any() and got[-1].all()


@pytest.mark.parametrize("n_chan,lanes_log2", [
    (0, 0), (1, 0), (4, 0), (5, 1), (16, 2), (17, 3), (33, 4), (64, 4),
    (1000, 4)])
def test_rrl_lanes_log2(n_chan, lanes_log2):
    assert kn.rrl_lanes_log2(n_chan) == lanes_log2
    group = kn.RRL_CPL << lanes_log2
    assert group >= min(n_chan, kn.RRL_MAX_GROUP)    # one group up to 64
    assert group <= kn.RRL_MAX_GROUP


@pytest.mark.parametrize("n_chan", [1, 3])
def test_rrl_tiles_maps_match_pallas(n_chan):
    """The maps wrapper (plain on the CPU) against the Pallas tile kernel
    and the JAX package's fold, in the interpreter: several tiles per
    segment out of segment order, an empty tile, a wholly jet tile."""
    rng = np.random.default_rng(8)
    shape = (5,) + kn.TILE
    amp = rng.random(shape) * 1e-3
    amp[rng.random(shape) < 0.5] = 0.0
    amp[1] = 0.0                                   # an empty tile
    amp[3] = rng.random(shape[1:]) * 1e-3 + 1e-6    # a wholly jet tile
    f = [amp, rng.uniform(-1e5, 1e5, shape), 1.0 / rng.uniform(2e5, 8e5, shape),
         rng.uniform(0.0, 3.0, shape), 4.8e-11 / rng.uniform(5e3, 2e4, shape)]
    f = [a.astype(np.float32) for a in f]
    fo = np.linspace(-4e6, 4e6, n_chan).astype(np.float32)
    seg = np.array([3, 0, 3, 1, 0], dtype=np.int32)
    nx, nz = 16, 200
    want = np.asarray(pk.segment_tile_maps(
        pk.rrl_tiles_pallas(jnp.asarray(fo), *(jnp.asarray(a) for a in f),
                            nu0=NU0, interpret=True),
        jnp.asarray(seg), nx, nz))
    order, seg_start = kn.segment_order(seg, 4)
    got = kn.rrl_tiles(torch.as_tensor(fo), *(torch.as_tensor(a) for a in f),
                       NU0, torch.as_tensor(order), torch.as_tensor(seg_start),
                       nx, nz)
    assert got.shape == (n_chan, nx, nz) and got.dtype == torch.float32
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got.numpy() - want).max() / scale < 1e-5
