"""The CUDA kernels (epoch, RRL, emergent and Faddeeva) against their
plain versions, the pipeline's copy-out, and the synthetic observation's device
stages against the CPU, on the card.

Needs an NVIDIA GPU with ``nvcc``; skipped elsewhere.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy
import os
import runpy

import numpy as np
import pytest
import torch

from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch import constants as cnsts
from rajepy_tpu_torch.ops import kernels as kn
from rajepy_tpu_torch.ops import physics
from rajepy_tpu_torch.ops import radtrans as rt
from rajepy_tpu_torch.ops import voigt
from rajepy_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YEAR = 31536000.0


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA-only)")
    return torch.device('cuda')


def _params(n):
    p = runpy.run_path(os.path.join(ROOT, 'rajepy_tpu_torch', 'data',
                                    'example-model-params.py'))['params']
    p = copy.deepcopy(p)
    p['grid'].update(n_x=n[0], n_y=n[1], n_z=n[2], l_z=None)
    return p


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def test_kernels_match_plain_versions(card):
    jm = JetModel(_params((64, 160, 64)), device=card)
    assert jm.dtype == torch.float32
    jm.time = 2.0 * YEAR
    st = jm._rt_static()
    bursts, off, t = jm._burst_tuple(), jm._ts_pack_offset, jm.time
    kn.reset_launches()
    got = kn.epoch_base_map_tiles(st.a_t, st.tss_t, st.seg, t, bursts,
                                  jm.nx, jm.nz, off)
    want = kn.epoch_base_map_tiles_plain(st.a_t, st.tss_t, st.seg, t,
                                         bursts, jm.nx, jm.nz, off)
    assert _rel(got, want) < 1e-5
    ga, gb = kn.epoch_base_maps2_tiles(st.a_t, st.em_t, st.tss_t, st.seg, t,
                                       bursts, jm.nx, jm.nz, off)
    wa, wb = kn.epoch_base_maps2_tiles_plain(st.a_t, st.em_t, st.tss_t,
                                             st.seg, t, bursts, jm.nx,
                                             jm.nz, off)
    assert _rel(ga, wa) < 1e-5 and _rel(gb, wb) < 1e-5
    got = kn.epoch_base_map_full(st.a, st.ts_signed, t, bursts, off)
    want = kn.epoch_base_map_full_plain(st.a, st.ts_signed, t, bursts, off)
    assert _rel(got, want) < 1e-5
    assert all(kn.LAUNCHES[k] == 1 for k in ('epoch_base_map_tiles',
                                             'epoch_base_maps2_tiles',
                                             'epoch_base_map_full'))
    with pytest.raises(TypeError, match='float32'):
        kn.epoch_base_map_full(st.a.double(), st.ts_signed.double(), t,
                               bursts, off)


def test_redesigned_tile_kernels_on_random_tiles(card):
    """The epoch tile kernel with one base (K1) and with two (K2):
    segments of 1 to 3 tiles out of order, positions with no tile: exact
    zeros; two calls bit-identical; K1's map of a base equal to K2's map of
    it bit for bit; the walk cached by the model, through which flux_ff
    and emission_measure equal continuum_rt_products exactly, one K1
    launch a map.  The emergent tile kernel at every block shape (1, 5,
    16, 64 and 70 channels).  All against their plain versions."""
    rng = np.random.default_rng(11)
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                  device=card)
    shape = (7,) + kn.TILE
    a, b = (rng.random(shape) * (rng.random(shape) < 0.4) for _ in range(2))
    a[::3] = 0.0
    ts = rng.uniform(-0.05 * YEAR, 2.5 * YEAR, shape)
    off = kn.pack_offset_for(ts.min())
    tss = np.where(rng.random(shape) < 0.5, -(ts + off), ts + off)
    jm = JetModel(_params((64, 160, 64)), device=card)
    bursts, t = jm._burst_tuple(), 2.0 * YEAR
    a_t, b_t, tss_t = f(a), f(b), f(tss)
    for seg_l, nx, nz in (([0, 0, 3, 1, 3, 2, 0], 24, 200),
                          ([5, 5, 5, 0, 1, 2, 2], 21, 300)):
        seg = torch.as_tensor(seg_l, device=card)
        got = kn.epoch_base_maps2_tiles(a_t, b_t, tss_t, seg, t, bursts, nx,
                                        nz, off)
        again = kn.epoch_base_maps2_tiles(a_t, b_t, tss_t, seg, t, bursts,
                                          nx, nz, off)
        want = kn.epoch_base_maps2_tiles_plain(a_t, b_t, tss_t, seg, t,
                                               bursts, nx, nz, off)
        one = [kn.epoch_base_map_tiles(x, tss_t, seg, t, bursts, nx, nz, off)
               for x in (a_t, b_t)]
        assert torch.equal(one[0], kn.epoch_base_map_tiles(
            a_t, tss_t, seg, t, bursts, nx, nz, off))
        assert all(torch.equal(g, k1) for g, k1 in zip(got, one))
        want1 = kn.epoch_base_map_tiles_plain(a_t, tss_t, seg, t, bursts, nx,
                                              nz, off)
        assert _rel(one[0], want1) < 1e-5
        n_zt = -(-nz // 128)
        for g, h, w in zip(got, again, want):
            assert torch.equal(g, h) and _rel(g, w) < 1e-5
            for p in set(range(-(-nx // 8) * n_zt)) - set(seg_l):
                x0, z0 = (p // n_zt) * 8, (p % n_zt) * 128
                assert not g[x0:x0 + 8, z0:z0 + 128].any()
    temp = np.where(a > 0, rng.uniform(5e3, 2e4, shape), 1.0)
    starts = f(kn.segment_starts(np.array([0, 0, 1, 2, 2, 2, 3]), 4)).int()
    for n_chan in (1, 5, 16, 64, 70):
        freqs = np.geomspace(3e8, 3e11, n_chan)
        cnu = f(2.0 * cnsts.H_CGS * freqs ** 3 / cnsts.C_CGS ** 2)
        hnuk = f(cnsts.H_CGS * freqs / cnsts.K_CGS)
        args = (cnu, hnuk, f(np.geomspace(300.0, 1e-3, n_chan)), f(temp),
                a_t, tss_t, starts, t, bursts, off)
        for g, w in zip(kn.emergent_tile_partials(*args),
                        kn.emergent_tile_partials_plain(*args)):
            assert _rel(g, w) < 1e-5
    st = jm._rt_static()
    got = kn.epoch_base_maps2_tiles(st.a_t, st.em_t, st.tss_t, st.seg,
                                    jm.time, bursts, jm.nx, jm.nz,
                                    jm._ts_pack_offset, walk=st.walk)
    want = kn.epoch_base_maps2_tiles_plain(st.a_t, st.em_t, st.tss_t,
                                           st.seg, jm.time, bursts, jm.nx,
                                           jm.nz, jm._ts_pack_offset)
    assert all(_rel(g, w) < 1e-5 for g, w in zip(got, want))
    freqs = np.geomspace(3e8, 3e11, 4)
    jm.time = 2.2 * YEAR
    em, _, flux = jm.continuum_rt_products(freqs)
    assert em.max() > 0 and flux.max() > 0
    kn.reset_launches()
    assert np.array_equal(jm.flux_ff(freqs), flux)
    assert kn.LAUNCHES['epoch_base_map_tiles'] == 1
    assert np.array_equal(jm.emission_measure(), em)
    assert kn.LAUNCHES['epoch_base_map_tiles'] == 2
    assert kn.LAUNCHES['epoch_base_maps2_tiles'] == 0


def test_f32_card_products_match_f64_cpu(card):
    freqs = np.geomspace(3e8, 3e11, 4)
    gpu = JetModel(_params((64, 160, 64)), device=card)
    cpu = JetModel(_params((64, 160, 64)), dtype='parity', device='cpu')
    gpu.time = cpu.time = 2.2 * YEAR
    for got, want in zip(gpu.continuum_rt_products(freqs),
                         cpu.continuum_rt_products(freqs)):
        err = np.max(np.abs(got - want)) / np.abs(want).max()
        assert err < 2e-4


def _wofz_grid(cut):
    """(x, y) across the interior, both sides of the wings' cut |x| + y =
    ``cut``, y < 3e-5 and y = 0, and |x| up to 1e4, both signs of x."""
    xs = np.concatenate([[0.0], np.logspace(-3, 4, 120),
                         cut + np.array([-1e-9, -1e-12, 0.0, 1e-12, 1e-9]),
                         np.linspace(0.5, cut + 1.0, 41)])
    xs = np.concatenate([xs, -xs])
    ys = np.concatenate([[0.0, 1e-12, 1e-6, 2.9e-5, 3e-5, 3.1e-5, 0.5,
                          cut - 1e-9, cut + 1e-9], np.logspace(-4, 3, 40)])
    x, y = np.meshgrid(xs, ys)
    # |x| + y just under and just over the cut with y > 0
    yw = np.repeat([0.3, 2.0, 5.0], 5)
    xw = cut - yw + np.tile([-1e-9, -1e-13, 0.0, 1e-13, 1e-9], 3)
    return (np.concatenate([x.ravel(), xw, -xw]),
            np.concatenate([y.ravel(), yw, yw]))


@pytest.mark.parametrize('dtype,cut,rtol', [(torch.float64, 9.0, 1e-13),
                                            (torch.float32, 8.0, 1e-5)])
def test_wofz_kernel_matches_plain_version(card, dtype, cut, rtol):
    x, y = (torch.as_tensor(a, dtype=dtype, device=card)
            for a in _wofz_grid(cut))
    launches = kn.LAUNCHES['wofz']
    n_kernel = profiling.COUNTERS.get('voigt.wofz_kernel', 0)
    got = voigt.wofz(x, y)
    assert kn.LAUNCHES['wofz'] == launches + 1
    assert profiling.COUNTERS['voigt.wofz_kernel'] == n_kernel + 1
    want = voigt._wofz_plain(x, y)
    assert all(g.dtype == dtype and g.is_cuda for g in got)

    def gap(g, w):
        g, w = [(a[0].double() + 1j * a[1].double()).cpu() for a in (g, w)]
        assert bool(torch.isfinite(w.abs()).all()) and float(w.abs().min()) > 0
        return float(((g - w).abs() / w.abs()).max())

    assert gap(got, want) <= rtol
    # expanded inputs: a row of x against a column of y, views of stride 0
    xr = x[:300].clone()
    yc = y[::97].clone()[:, None]
    xe, ye = torch.broadcast_tensors(xr, yc)
    assert xe.stride()[0] == 0 and ye.stride()[1] == 0
    got = voigt.wofz(xr, yc)
    assert got[0].shape == xe.shape and got[0].is_contiguous()
    assert kn.LAUNCHES['wofz'] == launches + 2
    assert gap(got, voigt._wofz_plain(xe.contiguous(), ye.contiguous())) \
        <= rtol
    with pytest.raises(TypeError, match='float64 or float32'):
        kn.wofz_kernel(x.half(), y.half())


def test_wofz_gradient_on_the_card(card):
    x = torch.linspace(-12.0, 12.0, 13, dtype=torch.float64, device=card)
    y = torch.tensor([1e-6, 0.3, 2.0, 8.5, 11.0], dtype=torch.float64,
                     device=card)
    xx, yy = (t.contiguous().requires_grad_() for t in
              torch.broadcast_tensors(x, y[:, None]))
    launches = kn.LAUNCHES['wofz']
    assert torch.autograd.gradcheck(voigt.wofz, (xx, yy), eps=1e-6,
                                    atol=1e-7, rtol=1e-5,
                                    check_forward_ad=True)
    assert kn.LAUNCHES['wofz'] > launches


def _rrl_band(n):
    nu0 = rt.RRLCoeffs('H58a').nu0
    return np.linspace(nu0 - 5e7, nu0 + 5e7, n)


def test_rrl_kernels_match_plain_versions(card):
    """The maps kernels (K4 on tiles, K5 on the grid) against their plain
    versions at 40, 1 and 33 channels, on a wholly jet tile, and in the
    per-tile layout; K5's activity pass against its plain version."""
    jm = JetModel(_params((64, 160, 64)), device=card)
    jm.time = 2.0 * YEAR
    coeffs = rt.RRLCoeffs('H58a')
    temp_t, vy_t, ndxi_t, ds_t, inside_t, tss_t, order, seg_start = \
        jm._rrl_tiles()
    n_es_t = ndxi_t * jm._chi_from_packed(tss_t, jm.time)
    f = jm._ensure_fields()
    walk = (order, seg_start, jm.nx, jm.nz)
    bands = [np.concatenate([_rrl_band(200)[::10], _rrl_band(2001)[990:1010]]),
             _rrl_band(2001)[1000:1001], _rrl_band(2001)[984:1017]]
    kn.reset_launches()
    for band in bands:
        freqs = jm._freqs(band)
        k4 = rt.rrl_kernel_inputs(coeffs, freqs, temp_t, n_es_t, vy_t, ds_t,
                                  inside_t)
        k5 = rt.rrl_kernel_inputs(coeffs, freqs, f.temp,
                                  jm._nd_chi(f, jm.time) * f.xi, f.vy,
                                  rt.path_length_cm(f.ff, f.area, jm.csize),
                                  f.inside)
        assert _rel(kn.rrl_tiles(*k4, *walk),
                    kn.rrl_tiles_plain(*k4, *walk)) < 1e-5
        assert _rel(kn.rrl_cube(*k5), kn.rrl_cube_plain(*k5)) < 1e-5
    torch.cuda.synchronize()
    assert kn.LAUNCHES['rrl_tiles_pallas'] == len(bands)
    assert kn.LAUNCHES['rrl_cube_pallas'] == len(bands)
    # every cell of tile 0 a jet cell: a wholly jet chunk is staged whole
    amp_t = k4[1].clone()
    amp_t[0] = amp_t.max()
    k4 = (k4[0], amp_t) + k4[2:]
    assert _rel(kn.rrl_tiles(*k4, *walk),
                kn.rrl_tiles_plain(*k4, *walk)) < 1e-5
    assert _rel(kn.rrl_tile_partials(*k4),
                kn.rrl_tile_partials_plain(*k4)) < 1e-5
    assert torch.equal(kn.rrl_row_activity(k5[1]),
                       kn.rrl_row_activity_plain(k5[1]))
    with pytest.raises(TypeError, match='float32'):
        kn.rrl_cube(k5[0], *(a.double() for a in k5[1:6]), k5[6])
    with pytest.raises(ValueError, match='int32'):
        kn.rrl_tiles(*k4, order.long(), *walk[1:])


def test_f32_card_rrl_products_match_f64_cpu(card):
    freqs = _rrl_band(1000)[::25]
    gpu = JetModel(_params((64, 160, 64)), device=card)
    cpu = JetModel(_params((64, 160, 64)), dtype='parity', device='cpu')
    gpu.time = cpu.time = 2.0 * YEAR
    kn.reset_launches()
    for lte in (True, False):
        got = gpu.rrl_rt_products('H58a', freqs, contsub=False, lte=lte)
        want = cpu.rrl_rt_products('H58a', freqs, contsub=False, lte=lte)
        for g, w in zip(got, want):
            assert np.max(np.abs(g - w)) / np.abs(w).max() < 1e-3
    assert kn.LAUNCHES['rrl_tiles_pallas'] == 2


def _flux_stage_inputs(card, n_chan, nx, nz, reynolds, seed=5):
    """The channel stage's float32 inputs on the card: ~40% of the pixels
    outside the silhouette (T = 0 there), tau_c = 0 on some inside pixels,
    optically thin (1e-9), thick (30) and moderate line opacities."""
    rng = np.random.default_rng(seed)
    freqs = torch.as_tensor(_rrl_band(n_chan), device=card).float()
    scale = rt.tau_ff_channel_scale(freqs, 1e4, reynolds)
    any_in = rng.uniform(size=(nx, nz)) > 0.4
    tau_c0 = rng.uniform(0.0, 3.0, (nx, nz)) * (rng.uniform(size=(nx, nz))
                                                > 0.2)
    tbar = np.where(any_in, rng.uniform(5e3, 1.2e4, (nx, nz)), 0.0)
    kind = rng.integers(0, 3, (n_chan, nx, nz))
    tau_l = np.choose(kind, [1e-9, 30.0, rng.uniform(0.0, 2.0, kind.shape)])

    def f32(a):
        return torch.as_tensor(a, device=card).float().contiguous()

    return (freqs, scale, f32(tau_c0 / float(scale[n_chan // 2])), f32(tbar),
            torch.as_tensor(any_in, device=card), f32(tau_l))


@pytest.mark.parametrize('reynolds', [False, True])
@pytest.mark.parametrize('contsub', [False, True])
def test_rrl_flux_kernel_matches_plain_version(card, contsub, reynolds):
    """The channel-stage kernel against its plain version on the card's
    tensors: 16-byte accesses over two channel blocks (70 channels), a
    ragged image (4-byte accesses) and a misaligned tau_L view; exactly 0
    outside the silhouette; one launch and one count a call."""
    where = (0.5, 120.0)    # cell size [au], distance [pc]
    for n_chan, nx, nz in ((70, 36, 52), (3, 5, 7)):
        args = _flux_stage_inputs(card, n_chan, nx, nz, reynolds)
        any_in = args[4]
        launches = kn.LAUNCHES['rrl_flux']
        n_kernel = profiling.COUNTERS.get('rt.rrl_flux_kernel', 0)
        got = kn.rrl_flux_maps(*args, *where, contsub)
        assert kn.LAUNCHES['rrl_flux'] == launches + 1
        assert profiling.COUNTERS['rt.rrl_flux_kernel'] == n_kernel + 1
        want = rt.rrl_flux_maps_lte(*args, *where, contsub)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool((got[:, ~any_in] == 0).all())
        inside = want[:, any_in]
        assert bool((inside > 0).all())
        assert float(((got[:, any_in] - inside).abs() / inside).max()) < 1e-6
        tau_l = args[5]
        buf = torch.empty(tau_l.numel() + 1, device=card)
        shifted = buf[1:].view(tau_l.shape).copy_(tau_l)
        assert shifted.data_ptr() % 16 != 0
        assert torch.equal(kn.rrl_flux_maps(*args[:5], shifted, *where,
                                            contsub), got)
    with pytest.raises(ValueError, match='no backward'):
        kn.rrl_flux_maps(*args[:5], args[5].clone().requires_grad_(),
                         *where, contsub)
    with pytest.raises(TypeError, match='float32'):
        kn.rrl_flux_maps(*args[:5], args[5].double(), *where, contsub)


def _map_gap(got, want):
    """The worst map's largest absolute error over its largest absolute
    value (the cube's `correct` gap)."""
    got, want = (np.asarray(a, dtype=float).reshape(-1, *a.shape[-2:])
                 for a in (got, want))
    return max(float(np.abs(g - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize('contsub', [False, True])
def test_card_rrl_run_through_the_flux_kernel_matches_f64_cpu(card, contsub):
    """A float32 card run launches the channel-stage kernel once and keeps
    the cube's limits against the float64 CPU run; a float64 card run
    takes the eager chain (no launch) and is the CPU's to 1e-9."""
    freqs = _rrl_band(1000)[::25]
    gpu = JetModel(_params((64, 160, 64)), device=card)
    gpu64 = JetModel(_params((64, 160, 64)), dtype=torch.float64,
                     device=card)
    cpu = JetModel(_params((64, 160, 64)), dtype='parity', device='cpu')
    gpu.time = gpu64.time = cpu.time = 2.0 * YEAR
    launches = kn.LAUNCHES['rrl_flux']
    got = gpu.rrl_rt_products('H58a', freqs, contsub=contsub)
    assert kn.LAUNCHES['rrl_flux'] == launches + 1
    got64 = gpu64.rrl_rt_products('H58a', freqs, contsub=contsub)
    assert kn.LAUNCHES['rrl_flux'] == launches + 1
    want = cpu.rrl_rt_products('H58a', freqs, contsub=contsub)
    for name, g, g64, w, limit in zip(('em', 'tau', 'flux'), got, got64,
                                      want, (1e-3, 5e-2, 1e-2)):
        assert _map_gap(g, w) < limit, name
        assert _map_gap(g64, w) < 1e-9, name


def test_emergent_kernels_match_plain_versions(card):
    jm = JetModel(_params((64, 160, 64)), device=card)
    jm.time = 2.2 * YEAR
    freqs = jm._freqs(np.geomspace(3e8, 3e11, 6))
    cnu, hnuk, scale = jm._emergent_channels(freqs)
    temp_t, a_t, tss_t, _, seg_start, it, kt = jm._emergent_tiles()[:7]
    bursts, off, t = jm._burst_tuple(), jm._ts_pack_offset, jm.time
    f = jm._ensure_fields()
    base = (jm._rt_static().a * jm._chi2(f, t)).contiguous()
    safe_t = torch.where(f.inside, f.temp, torch.ones_like(f.temp))
    src = torch.where(f.inside, physics.blackbody_nu(freqs[0], safe_t),
                      torch.zeros_like(safe_t))
    kn.reset_launches()
    k6 = (cnu, hnuk, scale, temp_t, a_t, tss_t, seg_start, t, bursts, off)
    for g, w in zip(kn.emergent_tile_partials(*k6),
                    kn.emergent_tile_partials_plain(*k6)):
        assert _rel(g, w) < 1e-5
    for near in (False, True):
        for g, w in zip(kn.emergent_ff_full(cnu, hnuk, scale, safe_t, base,
                                            near),
                        kn.emergent_ff_full_plain(cnu, hnuk, scale, safe_t,
                                                  base, near)):
            assert _rel(g, w) < 1e-5
        for g, w in zip(kn.transfer_scan_maps(src, base * scale[0], near),
                        kn.transfer_scan_maps_plain(src, base * scale[0],
                                                    near)):
            assert _rel(g, w) < 1e-5
    torch.cuda.synchronize()
    assert kn.LAUNCHES['emergent_ff_tiles'] == 1
    assert kn.LAUNCHES['emergent_ff_pallas'] == 2
    assert kn.LAUNCHES['transfer_scan_pallas'] == 2
    with pytest.raises(ValueError, match='int32'):
        kn.emergent_tile_partials(*k6[:6], seg_start.long(), *k6[7:])


def test_full_grid_kernels_on_ragged_grids_and_64_channels(card):
    """The two kernels that stream base through the shared-memory ring
    (epoch and emergent, full grid) against their plain versions: a grid
    with nz % 4 != 0 (4-byte copies), a wholly jet cube, an all-zero cube
    (exact zeros even where the launch times are not finite), a view off a
    16-byte boundary, and 1, 17 and 64 channels."""
    rng = np.random.default_rng(0)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    bursts = ((0.5 * YEAR, 1.0 / (2.0 * (0.13 * YEAR) ** 2), 4.0, True),
              (2.0 * YEAR, 1.0 / (2.0 * (0.42 * YEAR) ** 2), 9.0, False))
    t = 2.0 * YEAR
    kn.reset_launches()
    n_cases = 0
    for shape, frac, shift in (((10, 70, 130), 0.3, False),
                               ((9, 150, 128), 1.0, False),
                               ((6, 40, 64), 0.0, False),
                               ((8, 64, 128), 0.3, True)):
        inside = rng.random(shape) < frac
        ts = rng.uniform(-0.05 * YEAR, 2.5 * YEAR, shape)
        off = kn.pack_offset_for(ts.min())
        tss = np.where(rng.random(shape) < 0.5, -(ts + off), ts + off)
        if frac == 0.0:
            tss[::2] = np.nan
        cubes = [as_t(np.where(inside, 0.05 * (0.1 + rng.random(shape)), 0)),
                 as_t(tss),
                 as_t(np.where(inside, rng.uniform(5e3, 2e4, shape), 1.0))]
        if shift:
            bufs = [torch.empty(c.numel() + 1, device=card) for c in cubes]
            for buf, c in zip(bufs, cubes):
                buf[1:] = c.reshape(-1)
            cubes = [buf[1:].view(shape) for buf in bufs]
            assert cubes[0].data_ptr() % 16 != 0
        base, tss, temp = cubes
        got = kn.epoch_base_map_full(base, tss, t, bursts, off)
        want = kn.epoch_base_map_full_plain(base, tss, t, bursts, off)
        if frac == 0.0:
            assert not got.any() and not want.any()
        else:
            assert _rel(got, want) < 1e-5
        for n_chan in (1, 17, 64):
            freqs = torch.as_tensor(np.geomspace(1e9, 3e11, n_chan),
                                    device=card)
            cnu = (2.0 * 6.62607015e-27 * freqs ** 3 / 2.99792458e10 ** 2) \
                .to(torch.float32)
            hnuk = (6.62607015e-27 * freqs / 1.380649e-16).to(torch.float32)
            scale = as_t(np.geomspace(0.02, 5.0, n_chan))
            for near in (False, True):
                args = (cnu, hnuk, scale, temp, base, near)
                for g, w in zip(kn.emergent_ff_full(*args),
                                kn.emergent_ff_full_plain(*args)):
                    if frac == 0.0:
                        assert not g.any() and not w.any()
                    else:
                        assert _rel(g, w) < 1e-5
                n_cases += 1
    torch.cuda.synchronize()
    assert kn.LAUNCHES['epoch_base_map_full'] == 4
    assert kn.LAUNCHES['emergent_ff_pallas'] == n_cases == 24


def test_f32_card_emergent_matches_f64_cpu(card):
    freqs = np.geomspace(3e8, 3e11, 4)
    for inc, pa in ((90.0, 0.0), (55.0, 30.0)):
        p = _params((64, 160, 64))
        p['geometry'].update(inc=inc, pa=pa)
        gpu = JetModel(copy.deepcopy(p), device=card)
        cpu = JetModel(p, dtype='parity', device='cpu')
        gpu.time = cpu.time = 2.2 * YEAR
        kn.reset_launches()
        got = gpu.emergent_intensity_ff(freqs)
        want = cpu.emergent_intensity_ff(freqs)
        assert kn.LAUNCHES['emergent_ff_tiles'] == 1
        assert np.max(np.abs(got - want)) / np.abs(want).max() < 3e-3


def test_pipeline_on_the_card_reuses_its_pinned_buffers(card, tmp_path,
                                                        monkeypatch):
    """``Pipeline.execute`` on a CUDA model: one launch of the dual-base
    epoch kernel per run, each run's products copied out once by the
    model's ``products_to_host`` into blocks of its pinned pool, a run of
    the same shapes as the last reusing that run's blocks and making none,
    FITS products equal to the direct calls, and a resume that reloads the
    model on the card at float32."""
    from rajepy_tpu_torch import Pipeline
    from rajepy_tpu_torch.io.fits import read_fits
    none = {'t_obs': None, 'tscps': None, 't_ints': None}
    params = {
        'min_el': 20., 'dcys': {'model_dcy': str(tmp_path / 'out')},
        'continuum': dict(none, times=np.array([0.6, 2.2]),
                          freqs=np.array([6e9]), bws=np.array([4e8]),
                          chanws=np.array([2e8])),
        'rrls': dict(none, times=np.array([2.2]), lines=np.array(['H58a']),
                     bws=np.array([2e6]), chanws=np.array([2.5e5])),
    }
    jm = JetModel(_params((64, 160, 64)), device=card)
    pline = Pipeline(jm, params)
    seen = []
    to_host = JetModel.products_to_host

    def spy(model, maps):
        out = to_host(model, maps)
        # addresses only: the arrays must go back to the pool
        seen.append((model, [a.ctypes.data for a in out],
                     all(torch.from_numpy(a).is_pinned() for a in out),
                     profiling.COUNTERS['rt.products_out_pinned_new']))
        return out

    monkeypatch.setattr(JetModel, 'products_to_host', spy)
    kn.reset_launches()
    pline.execute(simobserve=False, verbose=False, plot=False)
    assert kn.LAUNCHES['epoch_base_maps2_tiles'] == 3
    assert kn.LAUNCHES['rrl_tiles_pallas'] == 1
    assert len(seen) == 3 and all(r.completed for r in pline.runs)
    assert all(model is jm and pinned for model, _, pinned, _ in seen)
    (_, addrs0, _, new0), (_, addrs1, _, new1) = seen[:2]
    assert set(addrs1) == set(addrs0) and new1 == new0     # recycled
    monkeypatch.undo()
    for run in pline.runs:
        jm.time = run.year * YEAR
        if run.obs_type == 'continuum':
            direct = jm.continuum_rt_products(run.chan_freqs)
        else:
            direct = jm.rrl_rt_products(run.line, run.chan_freqs,
                                        contsub=False)
        for path, arr in zip((run.fits_em, run.fits_tau, run.fits_flux),
                             direct):
            want = np.swapaxes(arr, -1, -2)
            np.testing.assert_allclose(read_fits(path)[0], want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    kn.reset_launches()
    pline.execute(simobserve=False, verbose=False, plot=False)
    assert not any(kn.LAUNCHES.values())
    assert pline.model is not jm and pline.model.device.type == 'cuda'
    assert pline.model.dtype == torch.float32
    loaded = Pipeline.load_pipeline(pline.save_file)
    assert loaded.model.device.type == 'cuda' and str(loaded) == str(pline)


def test_rt_products_come_out_in_recycled_pinned_memory(card):
    """``rrl_rt_products`` and ``continuum_rt_products`` on a CUDA model
    hand back views of pinned host memory; a held run's maps stay bit for
    bit what they were through three later runs at other epochs, and from
    the third run on the copy-out makes no new pinned block."""
    from rajepy_tpu_torch.utils import profiling
    jm = JetModel(_params((64, 160, 64)), device=card)
    freqs = _rrl_band(1000)[::10]

    def run(yr, as_numpy=True):
        jm.time = yr * YEAR
        return jm.rrl_rt_products('H58a', freqs, contsub=False,
                                  as_numpy=as_numpy)

    c = profiling.COUNTERS
    held = run(2.0)
    assert all(torch.from_numpy(a).is_pinned() for a in held)
    snap = [a.copy() for a in held]
    for a, t in zip(held, run(2.0, as_numpy=False)):
        assert np.array_equal(a, t.cpu().numpy())
    new = []
    for yr in (0.5, 3.5, 4.5, 1.0):
        assert sum(a.nbytes for a in run(yr)) == sum(s.nbytes for s in snap)
        new.append(c['rt.products_out_pinned_new'])
    assert new[0] == new[1] == new[2] == new[3]     # none in runs 3-5
    for a, s in zip(held, snap):
        assert np.array_equal(a, s)
    maps = jm.continuum_rt_products(np.geomspace(3e8, 3e11, 4))
    assert all(torch.from_numpy(a).is_pinned() for a in maps)


def test_synthobs_on_the_card_is_the_cpus_and_deterministic(card):
    """The synthetic observation's device stages on the card: sampling,
    weights and gridding to 1e-10 of the CPU's, two gridding calls bit for
    bit (no scatter-add), and Hogbom bit for bit the CPU's."""
    from rajepy_tpu_torch.synthobs import imaging, sampler
    rng = np.random.default_rng(3)
    sky = rng.random((2, 64, 64)) * 1e-3
    sky[:, 32, 30] += 1.0
    uvw = rng.normal(0.0, 2e3, (5000, 3))
    freqs = np.array([6e9, 6.2e9])
    vis = {d: sampler.sample_vis_cube(
        torch.as_tensor(sky, device=d), 2e-7, uvw, freqs, apply_pb=True,
        centre='fits') for d in ('cpu', card)}
    assert _rel(torch.view_as_real(vis[card]),
                torch.view_as_real(vis['cpu'])) < 1e-10
    lam = cnsts.C / freqs
    us = torch.as_tensor((uvw[None, :, 0] / lam[:, None]).ravel())
    vs = torch.as_tensor((uvw[None, :, 1] / lam[:, None]).ravel())
    cell = 1.0 / (4.0 * float(us.abs().max()) * 2.0)
    out = {}
    for d in ('cpu', card):
        u, v, x = us.to(d), vs.to(d), vis['cpu'].reshape(-1).to(d)
        wb = imaging.briggs_weights(u, v, torch.ones_like(u), 128, cell)
        out[d] = imaging.grid_and_image(u, v, x, wb, 128, cell)
        if d == card:
            again = imaging.grid_and_image(u, v, x, wb, 128, cell)
            assert all(torch.equal(a, b) for a, b in zip(out[d], again))
    for g, w in zip(out[card], out['cpu']):
        assert _rel(g, w) < 1e-10
    dirty, psf = (t.cpu() for t in out[card])
    mask = np.zeros((128, 128))
    mask[40:88, 40:88] = 1.0
    res = {d: imaging.hogbom_clean(dirty.to(d), psf.to(d), mask, niter=300)
           for d in ('cpu', card)}
    assert res[card][2] == res['cpu'][2] > 0
    assert torch.equal(res[card][0].cpu(), res['cpu'][0])
    assert torch.equal(res[card][1].cpu(), res['cpu'][1])


def _hogbom_cube(nc, n, box, seed):
    """(nc, n, n) dirty images and PSFs and an (n, n) mask of half-size
    ``box`` about the centre: each PSF a Gaussian core of its own width
    with a negative shelf, each dirty image three PSF-shaped sources of
    their own amplitude inside the mask plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    c0 = n // 2
    psf, dirty = [], rng.normal(0.0, 0.01, (nc, n, n))
    for c in range(nc):
        w = 2.0 + 0.3 * c

        def shape(py, px):
            r2 = (yy - py) ** 2 + (xx - px) ** 2
            return np.exp(-r2 / (2.0 * w * w)) - 0.1 * np.exp(
                -r2 / (18.0 * w * w))

        psf.append(shape(c0, c0) / 0.9)
        for _ in range(3):
            py, px = rng.integers(c0 - box, c0 + box, 2)
            dirty[c] += rng.uniform(0.5, 3.0) * shape(py, px)
    mask = np.zeros((n, n))
    mask[c0 - box:c0 + box, c0 - box:c0 + box] = 1.0
    return dirty, np.stack(psf), mask


def _gated_steps(counts, niter):
    """The steps ``imaging._gated`` runs for channels that took ``counts``
    iterations: to the first host check after the last active one."""
    from rajepy_tpu_torch.synthobs.imaging import HOGBOM_CHECK_EVERY as k
    top = max(counts)
    return niter if top >= niter else min(niter, k * (top // k + 1))


@pytest.mark.parametrize('dtype,nc,n,box,niter,thr', [
    # 12 channels, their own thresholds: one above its peak from the start,
    # some to niter, the rest stopping on their way
    (torch.float64, 12, 128, 40, 200,
     (9.0, 0.0, 0.5, 0.2, 0.05, 1.0, 0.0, 0.3, 0.1, 0.02, 0.7, 0.15)),
    # float32, none to niter: the host's check ends the loop (192 steps)
    (torch.float32, 12, 128, 40, 200,
     (9.0, 0.03, 0.5, 0.2, 0.05, 1.0, 0.04, 0.3, 0.1, 0.06, 0.7, 0.15)),
    # the observed cube's image and CLEAN box (500^2, half-size 85)
    (torch.float64, 4, 500, 85, 300, (0.3, 0.1, 0.05, 0.0)),
    # odd planes, each with a partial last tile: 499^2 with the cube's box,
    # and 47^2 (two tiles) with its box 3 pixels from the edges
    (torch.float64, 4, 499, 85, 300, (0.3, 0.1, 0.05, 0.0)),
    (torch.float32, 6, 47, 20, 70, (9.0, 0.6, 0.4, 0.25, 0.15, 0.0)),
])
def test_hogbom_kernel_is_the_plain_loop_bit_for_bit(card, dtype, nc, n,
                                                      box, niter, thr):
    """``hogbom_clean_batched`` on the card (the kernels of
    csrc/hogbom.cu) against the CPU's eager loop: models and residuals
    equal under ``torch.equal``, the same counts; two launches a step and
    one more to finish; ``obs.hogbom_calls`` and ``obs.hogbom_kernel``
    counted once each."""
    from rajepy_tpu_torch.synthobs import imaging
    dirty, psf, mask = (torch.as_tensor(a, dtype=dtype) for a in
                        _hogbom_cube(nc, n, box, seed=nc + n))
    want = imaging._hogbom(dirty, psf, mask, thr, 0.1, niter)
    counts = want[2].tolist()
    assert len(set(counts)) >= min(nc, 10)
    assert (counts[0] == 0) == (thr[0] > 5.0)
    launches = kn.LAUNCHES['hogbom']
    calls = profiling.COUNTERS.get('obs.hogbom_calls', 0)
    n_kernel = profiling.COUNTERS.get('obs.hogbom_kernel', 0)
    got = imaging.hogbom_clean_batched(dirty.to(card), psf.to(card), mask,
                                       thr, gain=0.1, niter=niter)
    assert got[2] == max(counts)
    assert kn.LAUNCHES['hogbom'] == launches + 2 * _gated_steps(
        counts, niter) + 1
    assert profiling.COUNTERS['obs.hogbom_calls'] == calls + 1
    assert profiling.COUNTERS['obs.hogbom_kernel'] == n_kernel + 1
    assert got[0].dtype == dtype and got[0].is_cuda
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    cycle = kn.HogbomCycle(dirty.to(card), psf.to(card), mask, thr, 0.1)
    imaging._gated(cycle.step, niter)
    assert cycle.finish()[2].cpu().tolist() == counts


def test_hogbom_kernel_refuses_what_it_does_not_take(card):
    """Another dtype than float64 or float32, or PSFs of another shape,
    raise; transposed views are taken as their contiguous copies."""
    dirty, psf, mask = (torch.as_tensor(a, device=card) for a in
                        _hogbom_cube(2, 64, 20, seed=5))
    from rajepy_tpu_torch.synthobs import imaging
    with pytest.raises(TypeError, match='float64 or float32'):
        imaging.hogbom_clean_batched(dirty.half(), psf.half(), mask,
                                     (0.1, 0.1))
    views = imaging.hogbom_clean_batched(
        dirty.transpose(1, 2), psf.transpose(1, 2), mask, (0.1, 0.1))
    copies = imaging.hogbom_clean_batched(
        dirty.transpose(1, 2).contiguous(), psf.transpose(1, 2).contiguous(),
        mask, (0.1, 0.1))
    assert views[2] == copies[2] > 0
    assert torch.equal(views[0], copies[0])
    assert torch.equal(views[1], copies[1])
    with pytest.raises(ValueError, match='one shape'):
        imaging.hogbom_clean_batched(dirty, psf[:, :32, :32], mask,
                                     (0.1, 0.1))
