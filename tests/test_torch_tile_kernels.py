"""The epoch tile kernel (K1 and K2, one kernel for one or two bases), the
emergent tile kernel (K6) and their shared burst factor, on the CPU.

The CUDA kernels (csrc/epoch_maps.cu, csrc/emergent_maps.cu, csrc/bursts.cuh)
cannot run here, so what they rely on from the host, and the arithmetic of
their designs, is emulated here with the kernels' own indexing and held
against the plain versions (and the Pallas kernel in the interpreter):

* ``_bursts_struct``: the burst list split by side, each side in its
  original order; ``burst_chi`` sums only the cell's own side's bursts, and
  a float32 emulation of that per-side loop equals ``_chi_plain`` bit for
  bit (the other side's terms are added there as zeros);
* the epoch tile kernel walks each (x, z) tile position's tiles through
  ``(order, seg_start)`` (cached once per model by ``JetModel._rt_static``),
  each thread summing a quarter of every tile's y cells, the quarters
  combined in a fixed order, cells whose bases are all 0 skipped; with one
  base (K1) it gives the two-base kernel's (K2) map of that base bit for
  bit;
* K6 splits each column's jet cells of a tile into K chunks, scans each
  from its own start to (I_k, tau_k), and folds the chunks in observer
  order, I += I_k e^{-tau}, tau += tau_k.
"""
import copy
import os
import runpy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rajepy_tpu.ops import pallas_kernels as pk
from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch import constants as cnsts
from rajepy_tpu_torch.ops import kernels as kn
from tests.torch_one_thread import one_thread  # noqa: F401

YEAR = 31536000.0
MAPS_GROUPS = 4         # y groups of a block (MAPS_GROUPS in epoch_maps.cu)


def _bundled_params(n=(32, 80, 32)):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = runpy.run_path(os.path.join(here, 'rajepy_tpu_torch', 'data',
                                    'example-model-params.py'))['params']
    p = copy.deepcopy(p)
    p['grid'].update(n_x=n[0], n_y=n[1], n_z=n[2], l_z=None)
    return p


def _random_tiles(rng, n_act, dtype=np.float32, empty_every=3):
    """Two bases (zeros in every ``empty_every``-th tile and in 60% of the
    cells) and packed launch times with negative travel times."""
    shape = (n_act,) + kn.TILE
    a = rng.random(shape) * (rng.random(shape) < 0.4)
    b = rng.random(shape) * (rng.random(shape) < 0.4)
    a[::empty_every] = 0.0
    b[::empty_every] = 0.0
    ts = rng.uniform(-0.05 * YEAR, 2.5 * YEAR, shape)
    ts[min(1, n_act - 1)] = rng.uniform(-0.05 * YEAR, 0.0, shape[1:])
    off = kn.pack_offset_for(ts.min())
    tss = np.where(rng.random(shape) < 0.5, -(ts + off), ts + off)
    return (torch.as_tensor(a.astype(dtype)), torch.as_tensor(b.astype(dtype)),
            torch.as_tensor(tss.astype(dtype)), off)


# --------------------------------------------------------------------------- #
# burst_chi per side
# --------------------------------------------------------------------------- #
def test_bursts_struct_splits_the_bundled_jet_by_side():
    jm = JetModel(_bundled_params(), dtype=torch.float32, device='cpu')
    bursts = jm._burst_tuple()
    s = kn._bursts_struct(bursts)
    red = [round(s.p[kn.SIDE_RED][i][0] / YEAR, 6)
           for i in range(s.n[kn.SIDE_RED])]
    blue = [round(s.p[kn.SIDE_BLUE][i][0] / YEAR, 6)
            for i in range(s.n[kn.SIDE_BLUE])]
    assert red == [0.5, 2.0] and blue == [0.75, 1.0, 2.0]
    for side, is_red in ((kn.SIDE_RED, True), (kn.SIDE_BLUE, False)):
        want = [b for b in bursts if bool(b[3]) == is_red]
        for i, (t0, inv2s2, amp, _) in enumerate(want):
            assert tuple(s.p[side][i][:3]) == tuple(
                float(np.float32(v)) for v in (t0, inv2s2, amp))
        assert all(v == 0.0 for i in range(len(want), kn.MAX_BURSTS)
                   for v in s.p[side][i])


def _chi_per_side(tss, t, bursts, off):
    """The kernels' burst_chi in float32: lt unpacked from |tss|, then for
    each cell only its own side's bursts, in list order, each term
    amp * exp(-(d * d) * inv2s2) added to chi (the exponential is torch's,
    as in the plain version)."""
    f32 = np.float32
    tss = np.asarray(tss, dtype=f32)
    lt = f32(t) - (np.abs(tss) - f32(off))
    red = tss < 0
    chi = np.ones_like(lt)
    for side_red in (True, False):
        side = [b for b in bursts if bool(b[3]) == side_red]
        mask = red if side_red else ~red
        acc = np.ones(int(mask.sum()), dtype=f32)
        for t0, inv2s2, amp, _ in side:
            d = lt[mask] - f32(t0)
            e = -(d * d) * f32(inv2s2)
            g = f32(amp) * torch.exp(torch.as_tensor(e)).numpy()
            acc = acc + g
        chi[mask] = acc
    return chi


@pytest.mark.parametrize("inc,pa", [(90.0, 0.0), (55.0, 30.0)])
def test_per_side_chi_equals_chi_plain_bit_for_bit(inc, pa):
    """Random packed launch times with negative travel times, at the
    bundled jet's bursts and epochs around them; the off-axis geometry
    gives the model's own negative travel times too."""
    p = _bundled_params()
    p['geometry'].update(inc=inc, pa=pa)
    jm = JetModel(p, dtype=torch.float32, device='cpu')
    jm.time = 2.0 * YEAR
    st = jm._rt_static()
    bursts, off = jm._burst_tuple(), jm._ts_pack_offset
    rng = np.random.default_rng(7)
    ts = rng.uniform(-0.1 * YEAR, 2.5 * YEAR, 20000)
    off_r = kn.pack_offset_for(ts.min())
    tss_r = np.where(rng.random(ts.size) < 0.5, -(ts + off_r), ts + off_r)
    for tss, o in ((st.ts_signed.reshape(-1), off),
                   (torch.as_tensor(tss_r.astype(np.float32)), off_r)):
        for t_yr in (0.5, 1.0, 2.0, 2.2):
            want = kn._chi_plain(tss, t_yr * YEAR, bursts, o).numpy()
            got = _chi_per_side(tss.numpy(), t_yr * YEAR, bursts, o)
            assert want.max() > 1.0
            np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# K1 and K2: the segment walk and the fixed-order combine
# --------------------------------------------------------------------------- #
def _k2_walk(bases, tss_t, order, seg_start, t, bursts, off, nx, nz):
    """epoch_maps_kernel<NB>'s walk in numpy, in the tiles' dtype, for the
    NB = len(bases) bases: item (position s, x row xr); thread (z, g) sums
    y = 16 g .. 16 g + 15 of each of the position's tiles in walk order,
    skipping cells whose bases are all 0; group 0 adds the four groups'
    sums in order; rows and columns beyond the grid are dropped, positions
    with no tile give exact 0.  Returns the (NB, nx, nz) maps."""
    bs = np.stack([x.numpy() for x in bases])
    nb = len(bases)
    chi = kn._chi_plain(tss_t, t, bursts, off).numpy()
    chi2 = chi * chi
    _, _, bx, ny, bz = bs.shape
    rows = ny // MAPS_GROUPS
    n_zt = -(-nz // bz)
    out = np.full((nb, nx, nz), np.nan, dtype=bs.dtype)
    for s in range(len(seg_start) - 1):
        tiles = order[seg_start[s]:seg_start[s + 1]]
        for xr in range(bx):
            x = (s // n_zt) * bx + xr
            if x >= nx:
                continue
            z0 = (s % n_zt) * bz
            nzs = min(bz, nz - z0)
            part = np.zeros((nb, MAPS_GROUPS, bz), dtype=bs.dtype)
            for g in range(MAPS_GROUPS):
                for k in tiles:
                    for y in range(g * rows, (g + 1) * rows):
                        v, c2 = bs[:, k, xr, y], chi2[k, xr, y]
                        live = (v != 0).any(axis=0)
                        part[:, g] = np.where(live, part[:, g] + v * c2,
                                              part[:, g])
            tot = part[:, 0].copy()
            for g in range(1, MAPS_GROUPS):
                tot = tot + part[:, g]
            out[:, x, z0:z0 + nzs] = tot[:, :nzs]
    return out


def _plain_maps(bases, tss_t, seg, t, bursts, nx, nz, off):
    """The plain version of the kernel for one or two bases."""
    if len(bases) == 1:
        return (kn.epoch_base_map_tiles_plain(bases[0], tss_t, seg, t,
                                              bursts, nx, nz, off),)
    return kn.epoch_base_maps2_tiles_plain(*bases, tss_t, seg, t, bursts, nx,
                                           nz, off)


def _wrapper_maps(bases, tss_t, seg, t, bursts, nx, nz, off, walk):
    """The wrapper of the kernel for one or two bases, given the walk."""
    if len(bases) == 1:
        return (kn.epoch_base_map_tiles(bases[0], tss_t, seg, t, bursts, nx,
                                        nz, off, walk=walk),)
    return kn.epoch_base_maps2_tiles(*bases, tss_t, seg, t, bursts, nx, nz,
                                     off, walk=walk)


@pytest.mark.parametrize("seg_l,nx,nz", [
    ([0, 0, 3, 1, 3, 2, 0], 16, 200),     # segments of 3, 2, 1, 1 tiles
    ([0, 0, 3, 1, 3, 2, 0], 24, 200),     # two positions with no tile
    ([5, 5, 5, 0, 1, 2, 2], 21, 300),     # ragged x and z, empty positions
])
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (np.float64, 1e-12)])
@pytest.mark.parametrize("n_bases", [1, 2])
def test_k2_walk_matches_the_plain_maps(seg_l, nx, nz, dtype, rtol,
                                        n_bases):
    rng = np.random.default_rng(len(seg_l) + nx)
    a_t, b_t, tss_t, off = _random_tiles(rng, len(seg_l), dtype)
    bases = (a_t, b_t)[:n_bases]
    jm = JetModel(_bundled_params(), dtype=torch.float32, device='cpu')
    bursts, t = jm._burst_tuple(), 2.0 * YEAR
    seg = np.asarray(seg_l)
    n_seg = -(-nx // 8) * -(-nz // 128)
    order, seg_start = kn.segment_order(seg, n_seg)
    got = _k2_walk(bases, tss_t, order, seg_start, t, bursts, off, nx, nz)
    want = _plain_maps(bases, tss_t, torch.as_tensor(seg), t, bursts, nx,
                       nz, off)
    assert len(got) == len(want) == n_bases
    for g, w in zip(got, want):
        w = w.numpy()
        assert not np.isnan(g).any()
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * w.max())
    empty = set(range(n_seg)) - set(seg_l)
    n_zt = -(-nz // 128)
    for s in empty:
        assert not got[:, (s // n_zt) * 8:(s // n_zt) * 8 + 8,
                       (s % n_zt) * 128:(s % n_zt) * 128 + 128].any()
    # on the CPU the wrapper is the plain version, walk or none
    by_walk = _wrapper_maps(bases, tss_t, torch.as_tensor(seg), t, bursts,
                            nx, nz, off,
                            tuple(torch.as_tensor(w) for w in
                                  (order, seg_start)))
    for g, w in zip(by_walk, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seg_l,nx,nz", [
    ([0, 0, 3, 1, 3, 2, 0], 24, 200),
    ([5, 5, 5, 0, 1, 2, 2], 21, 300),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_one_base_walk_is_the_two_base_walks_map_bit_for_bit(seg_l, nx, nz,
                                                             dtype):
    """One summation order for both instantiations: the one-base walk of
    a (or of b) equals the two-base walk's map of it, although a cell where
    only the other base is non-zero is skipped by one and adds +0 in the
    other."""
    rng = np.random.default_rng(nx + nz)
    a_t, b_t, tss_t, off = _random_tiles(rng, len(seg_l), dtype)
    assert bool(((a_t == 0) & (b_t != 0)).any())
    jm = JetModel(_bundled_params(), dtype=torch.float32, device='cpu')
    bursts, t = jm._burst_tuple(), 2.0 * YEAR
    order, seg_start = kn.segment_order(np.asarray(seg_l),
                                        -(-nx // 8) * -(-nz // 128))
    walk = (order, seg_start, t, bursts, off, nx, nz)
    both = _k2_walk((a_t, b_t), tss_t, *walk)
    for j, base in enumerate((a_t, b_t)):
        one = _k2_walk((base,), tss_t, *walk)
        assert one.shape == (1, nx, nz) and one.any()
        np.testing.assert_array_equal(one[0], both[j])


@pytest.mark.parametrize("inc", [90.0, 30.0])
@pytest.mark.parametrize("n_bases", [1, 2])
def test_k2_walk_on_the_conftest_jet(model_params, inc, n_bases):
    """The 32x80x32 test jet; at inc 30 two y tiles lie on some tile
    positions.  The walk is the one _rt_static caches (and the RRL tiles
    share), in float32 and, cast, in float64: the one-base walk of a (K1)
    and the two-base walk of a and em (K2)."""
    p = copy.deepcopy(model_params)
    p['geometry']['inc'] = inc
    jm = JetModel(p, dtype=torch.float32, device='cpu')
    jm.time = 2.0 * YEAR
    st = jm._rt_static()
    order, seg_start = (w.numpy() for w in st.walk)
    assert st.walk[0].dtype == torch.int32 and st.walk[1].dtype == torch.int32
    want_walk = kn.segment_order(st.seg.numpy(), seg_start.size - 1)
    np.testing.assert_array_equal(order, want_walk[0])
    np.testing.assert_array_equal(seg_start, want_walk[1])
    assert jm._rrl_tiles()[6] is st.walk[0]          # shared, not rebuilt
    assert np.any(np.diff(seg_start) > 1) == (inc == 30.0)
    bursts, off = jm._burst_tuple(), jm._ts_pack_offset
    for dtype, rtol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        bases = tuple(x.to(dtype) for x in (st.a_t, st.em_t))[:n_bases]
        tss_t = st.tss_t.to(dtype)
        got = _k2_walk(bases, tss_t, order, seg_start, jm.time, bursts, off,
                       jm.nx, jm.nz)
        want = _plain_maps(bases, tss_t, st.seg, jm.time, bursts, jm.nx,
                           jm.nz, off)
        for g, w in zip(got, want):
            w = w.numpy()
            assert w.max() > 0
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * w.max())


def test_epoch_base_map_hands_the_cached_walk_to_the_kernel(model_params,
                                                            monkeypatch):
    """Every single-base map of a float32 model (flux_ff, intensity_ff,
    optical_depth_ff, emission_measure, the RRL continuum) reaches the
    tile kernel through JetModel._epoch_base_map with the walk cached in
    RTStatic, so no epoch derives it on the host."""
    jm = JetModel(copy.deepcopy(model_params), dtype=torch.float32,
                  device='cpu')
    jm.time = 2.0 * YEAR
    st = jm._rt_static()
    assert st.walk is not None
    seen = []
    wrapper = kn.epoch_base_map_tiles

    def spy(*args, **kwargs):
        seen.append(kwargs.get('walk'))
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(kn, 'epoch_base_map_tiles', spy)
    f = jm._ensure_fields()
    for kind, base_t in (('a', st.a_t), ('em', st.em_t)):
        got = jm._epoch_base_map(kind, f, st, jm.time)
        want = kn.epoch_base_map_tiles_plain(base_t, st.tss_t, st.seg,
                                             jm.time, jm._burst_tuple(),
                                             jm.nx, jm.nz,
                                             jm._ts_pack_offset)
        assert torch.equal(got, want)
    jm.flux_ff(np.array([6e9]))
    jm.emission_measure()
    assert len(seen) == 4 and all(w is st.walk for w in seen)


# --------------------------------------------------------------------------- #
# K6: each column's jet cells in K chunks, folded in observer order
# --------------------------------------------------------------------------- #
def _k6_chunks(cnu, hnuk, scale, temp_t, a_t, tss_t, starts, t, bursts,
               off):
    """emergent_tiles_kernel's arithmetic in torch, in the tiles' dtype:
    the channel groups and chunks of emergent_tile_groups_log2; per tile,
    chunk k of a column takes its jet cells (a != 0) of ranks
    n k / K .. n (k + 1) / K - 1 (integer division) and scans them from its
    own start to (I_k, tau_k); the chunks fold into the column's running
    (I, tau) in observer order, I += I_k e^{-tau}, tau += tau_k (a chunk
    with tau_k = 0 is skipped).  Exact expm1 and exp, as the plain
    version: the combine alone is emulated.  Returns (n_seg, n_chan, 8,
    128) I and tau."""
    n_chan = cnu.shape[0]
    chunks = kn.EMERGENT_TILE_WARPS >> kn.emergent_tile_groups_log2(n_chan)
    chan = (slice(None), None, None, None)
    chi = kn._chi_plain(tss_t, t, bursts, off)
    base = a_t * chi * chi
    live = a_t != 0
    # each cell's rank among its column's jet cells, and its column's count
    rank = torch.cumsum(live.to(torch.int64), dim=2) - 1
    n = live.sum(dim=2, keepdim=True)
    out_i, out_tau = [], []
    for s0, s1 in zip(starts[:-1], starts[1:]):
        run_i = a_t.new_zeros((n_chan,) + a_t.shape[1:2] + a_t.shape[3:])
        run_tau = torch.zeros_like(run_i)
        for k in range(s0, s1):
            d = scale[chan] * base[k][None]              # (c, x, y, z)
            src = cnu[chan] / torch.expm1(hnuk[chan] / temp_t[k][None])
            emit = torch.where(live[k][None], src * -torch.expm1(-d),
                               torch.zeros_like(d))
            for c in range(chunks):
                lo, hi = (n[k] * c) // chunks, (n[k] * (c + 1)) // chunks
                mine = live[k] & (rank[k] >= lo) & (rank[k] < hi)
                d_c = torch.where(mine[None], d, torch.zeros_like(d))
                tau_in = kn.exclusive_cumsum(d_c, 2)
                i_c = torch.sum(torch.where(mine[None],
                                            emit * torch.exp(-tau_in),
                                            torch.zeros_like(d)), dim=2)
                tau_c = torch.sum(d_c, dim=2)
                run_i = torch.where(tau_c != 0,
                                    run_i + i_c * torch.exp(-run_tau), run_i)
                run_tau = run_tau + tau_c
        out_i.append(run_i)
        out_tau.append(run_tau)
    return torch.stack(out_i), torch.stack(out_tau)


def _k6_case(rng, n_chan, dtype):
    """Seven tiles in four segments of 2, 1, 3 and 1 (the last fully
    empty), jet cells bunched in y as a jet's are, and channels whose tau
    reaches the hundreds."""
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype)
    shape = (7,) + kn.TILE
    y = np.arange(kn.TILE[1])[None, None, :, None]
    band = (y > 10) & (y < 10 + rng.integers(5, 50, (7, 8, 1, 128)))
    a = np.where(band & (rng.random(shape) < 0.7),
                 0.05 * rng.random(shape), 0.0)
    a[6] = 0.0
    temp = np.where(a > 0, rng.uniform(5e3, 2e4, shape), 1.0)
    ts = rng.uniform(-0.05 * YEAR, 2.5 * YEAR, shape)
    off = kn.pack_offset_for(ts.min())
    tss = np.where(rng.random(shape) < 0.5, -(ts + off), ts + off)
    freqs = np.geomspace(3e8, 3e11, n_chan)
    cnu = 2.0 * cnsts.H_CGS * freqs ** 3 / cnsts.C_CGS ** 2
    hnuk = cnsts.H_CGS * freqs / cnsts.K_CGS
    scale = np.geomspace(2.0, 1e-3, n_chan)
    starts = kn.segment_starts(np.array([0, 0, 1, 2, 2, 2, 3]), 4)
    return (f(cnu), f(hnuk), f(scale), f(temp), f(a), f(tss),
            starts, 2.0 * YEAR, off)


@pytest.mark.parametrize("n_chan", [1, 5, 16])
def test_k6_chunk_fold_matches_the_plain_version(n_chan):
    rng = np.random.default_rng(n_chan)
    jm = JetModel(_bundled_params(), dtype=torch.float32, device='cpu')
    bursts = jm._burst_tuple()
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        (cnu, hnuk, scale, temp_t, a_t, tss_t, starts, t,
         off) = _k6_case(rng, n_chan, dtype)
        args = (cnu, hnuk, scale, temp_t, a_t, tss_t)
        got = _k6_chunks(*args, starts, t, bursts, off)
        want = kn.emergent_tile_partials_plain(
            *args, torch.as_tensor(starts), t, bursts, off)
        assert float(want[1].max()) > 100.0          # tau in the hundreds
        for g, w in zip(got, want):
            scale_w = float(w.abs().max())
            assert float((g - w).abs().max()) <= rtol * scale_w
        assert not got[0][3].any() and not got[1][3].any()
        if dtype == torch.float32:
            pallas = pk.emergent_ff_tiles(
                *(jnp.asarray(x.numpy()) for x in args),
                jnp.asarray(np.repeat(np.arange(4), np.diff(starts))), t,
                bursts, 4, interpret=True, pack_offset=off)
            for g, w in zip(got, pallas):
                w = np.asarray(w, dtype=np.float64)
                err = np.abs(g.double().numpy() - w).max()
                assert err <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("n_chan,groups_log2", [
    (1, 0), (4, 0), (5, 1), (8, 1), (16, 2), (17, 3), (64, 4), (70, 4),
    (1000, 4)])
def test_emergent_tile_groups(n_chan, groups_log2):
    """A block of the tile kernel is G channel groups of
    EMERGENT_CPT_TILES channels times 16 / G chunks; G covers the channels
    up to 16 groups, and beyond 64 channels blocks walk channel blocks."""
    assert kn.emergent_tile_groups_log2(n_chan) == groups_log2
    assert kn.EMERGENT_TILE_WARPS >> groups_log2 >= 1
