"""The two full-grid kernels' plain versions and glue, on the CPU.

The CUDA kernels ``epoch_full_kernel`` and ``emergent_full_kernel`` stream
their base cube through a shared-memory ring and touch their second cube
only where base != 0; they run on the card alone.  Here their plain
versions, which the wrappers take for CPU tensors, are held against the
Pallas kernels run in the interpreter (1e-5 of the map maximum: the f32
sums are taken in another order), and the property that makes the skip
exact (finite packed launch times) is checked on the bundled
configurations.

Inputs are made with numpy from a seed and handed to both packages.
"""
import copy
import os
import runpy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rajepy_tpu import constants as jcnsts
from rajepy_tpu.ops import pallas_kernels as pk
from rajepy_tpu_torch import JetModel
from rajepy_tpu_torch.ops import kernels as kn
from tests.torch_one_thread import one_thread  # noqa: F401

YEAR = 31536000.0
F32 = np.float32
BURSTS = ((0.5 * YEAR, 1.0 / (2.0 * (0.13 * YEAR) ** 2), 4.0, True),
          (0.75 * YEAR, 1.0 / (2.0 * (0.13 * YEAR) ** 2), 4.0, False),
          (1.0 * YEAR, 1.0 / (2.0 * (0.38 * YEAR) ** 2), 1.5, False),
          (2.0 * YEAR, 1.0 / (2.0 * (0.42 * YEAR) ** 2), 9.0, True),
          (2.0 * YEAR, 1.0 / (2.0 * (0.42 * YEAR) ** 2), 9.0, False))
RAGGED = (10, 70, 130)              # nz % 4 != 0


def _rel(got, want):
    got = np.asarray(got, dtype=float)
    want = np.asarray(want, dtype=float)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    return np.max(np.abs(got - want)) / scale


def _epoch_inputs(seed, shape, frac):
    """f32 base cube with a share ``frac`` of jet cells, and packed launch
    times that include negative travel times."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.random(shape) < frac, rng.random(shape), 0.0)
    ts = rng.uniform(-0.05 * YEAR, 2.5 * YEAR, shape)
    red = rng.random(shape) < 0.5
    off = kn.pack_offset_for(ts.min())
    tss = np.where(red, -(ts + off), ts + off)
    return a.astype(F32), tss.astype(F32), off


@pytest.mark.parametrize("frac", [0.3, 1.0, 0.0],
                         ids=['sparse', 'wholly_jet', 'all_zero'])
def test_epoch_full_plain_matches_pallas_on_a_ragged_grid(frac):
    a, tss, off = _epoch_inputs(11, RAGGED, frac)
    t = 1.9 * YEAR
    want = np.asarray(pk.epoch_base_map_pallas(
        jnp.asarray(a), jnp.asarray(tss), t, BURSTS, interpret=True,
        pack_offset=off))
    got = kn.epoch_base_map_full(torch.as_tensor(a), torch.as_tensor(tss), t,
                                 BURSTS, off)
    assert got.dtype == torch.float32
    assert got.shape == (RAGGED[0], RAGGED[2])
    if frac == 0.0:
        assert not want.any() and not got.numpy().any()
    else:
        assert _rel(got, want) < 1e-5


def test_epoch_full_plain_skips_cells_with_zero_base():
    """A cell with base = 0 adds exactly 0 even where its packed launch
    time is not finite; the cells with base != 0 are summed as before."""
    a, tss, off = _epoch_inputs(12, RAGGED, 0.3)
    t = 2.1 * YEAR
    want = kn.epoch_base_map_full_plain(torch.as_tensor(a),
                                        torch.as_tensor(tss), t, BURSTS, off)
    bad = tss.copy()
    bad[a == 0] = np.where(np.arange((a == 0).sum()) % 2, np.nan, np.inf)
    got = kn.epoch_base_map_full_plain(torch.as_tensor(a),
                                       torch.as_tensor(bad), t, BURSTS, off)
    assert torch.equal(got, want)
    zeros = kn.epoch_base_map_full(torch.zeros(RAGGED),
                                   torch.full(RAGGED, float('nan')), t,
                                   BURSTS, off)
    assert zeros.shape == (RAGGED[0], RAGGED[2])
    assert torch.equal(zeros, torch.zeros_like(zeros))


def _emergent_inputs(seed, shape, n_chan):
    """Channel constants, safe temperature (1 outside the jet) and a
    frequency-independent opacity base with a zero-opacity y range."""
    rng = np.random.default_rng(seed)
    inside = rng.random(shape) < 0.3
    inside[:, 8:16] = False
    temp = np.where(inside, 1e4 * (0.5 + rng.random(shape)), 1.0)
    base = np.where(inside, 0.05 * rng.random(shape), 0.0)
    freqs = np.geomspace(1e9, 5e10, n_chan)
    cnu = 2.0 * jcnsts.H_CGS * freqs ** 3 / jcnsts.C_CGS ** 2
    hnuk = jcnsts.H_CGS * freqs / jcnsts.K_CGS
    scale = np.geomspace(0.02, 5.0, n_chan)
    return [x.astype(F32) for x in (cnu, hnuk, scale, temp, base)]


@pytest.mark.parametrize("observer_near_y0", [False, True])
@pytest.mark.parametrize("n_chan", [1, 16, 17, 64])
def test_emergent_full_plain_matches_pallas(n_chan, observer_near_y0):
    """1, 16, 17 and 64 channels: one group of the CUDA kernel, four, one
    more than four, and a whole block of them."""
    shape = (6, 24, 130)
    args = _emergent_inputs(13, shape, n_chan)
    want_i, want_tau = pk.emergent_ff_pallas(
        *(jnp.asarray(a) for a in args), observer_near_y0=observer_near_y0,
        y_chunk=8, interpret=True)
    got_i, got_tau = kn.emergent_ff_full(
        *(torch.as_tensor(a) for a in args), observer_near_y0)
    assert got_i.shape == got_tau.shape == (n_chan, shape[0], shape[2])
    assert _rel(got_i, want_i) < 1e-5
    assert _rel(got_tau, want_tau) < 1e-5


def test_emergent_channel_grouping_constants():
    """A block of the full-grid emergent kernel takes whole groups of
    channels, and the wrapper's launch-grid check follows the block."""
    assert kn.EMERGENT_GROUP_FULL % kn.EMERGENT_CPT_FULL == 0
    assert kn.EMERGENT_GROUP_FULL // kn.EMERGENT_CPT_FULL * kn.STRIP_W <= 1024
    chan = [torch.zeros(3)] * 3
    with pytest.raises(ValueError, match='unsupported device'):
        kn.emergent_ff_full(*chan, torch.zeros((2, 3, 4), device='meta'),
                            torch.zeros((2, 3, 4), device='meta'))


def _bundled_params():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = runpy.run_path(os.path.join(here, 'rajepy_tpu_torch', 'data',
                                    'example-model-params.py'))['params']
    p = copy.deepcopy(p)
    p['grid'].update(n_x=32, n_y=80, n_z=32, l_z=None)
    return p


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=['f32', 'f64'])
@pytest.mark.parametrize("inc,pa", [(90.0, 0.0), (55.0, 30.0)])
def test_packed_launch_times_are_finite(inc, pa, dtype):
    """The full-grid epoch kernel skips cells with base = 0, which is exact
    only where the packed launch time is finite: it is, everywhere, for
    the bundled example jet on axis and off axis (where travel times go
    negative), at both dtypes."""
    p = _bundled_params()
    p['geometry'].update(inc=inc, pa=pa)
    jm = JetModel(p, dtype=dtype, device='cpu')
    st = jm._rt_static()
    assert st.ts_signed.dtype == dtype
    assert st.ts_signed.shape == (32, 80, 32)
    assert bool(torch.isfinite(st.ts_signed).all())
    assert bool((st.ts_signed.abs() > 0).all())
    assert bool(torch.isfinite(st.a).all())


def test_packed_launch_times_are_finite_for_the_test_jet(model_params):
    jm = JetModel(model_params, dtype=torch.float32, device='cpu')
    st = jm._rt_static()
    assert bool(torch.isfinite(st.ts_signed).all())
    assert bool((st.ts_signed.abs() > 0).all())
