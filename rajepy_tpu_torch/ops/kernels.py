"""Per-epoch burst-map and RRL kernels and their compaction glue (PyTorch
port of the continuum and RRL parts of rajepy_tpu.ops.pallas_kernels).

The per-epoch half of the free-free/EM products is the LOS sum

    map(x, z) = sum_y base * chi(t - ts)^2,

with chi the burst factor (models.ejection.chi_field) evaluated per cell
from a static list of bursts.  Three hand-written CUDA kernels for Hopper
(``csrc/epoch_maps.cu``) compute it, two over compacted tiles and one over
the full grid (it streams base through a shared-memory ring and reads the
launch times only where base != 0, see ``csrc/stream.cuh``):

==========================  ===================================  ========
wrapper                     TPU kernel replaced                  route
==========================  ===================================  ========
``epoch_base_map_tiles``    pallas_kernels.epoch_base_map_tiles  cuda
``epoch_base_maps2_tiles``  pallas_kernels.epoch_base_maps2_...  cuda
``epoch_base_map_full``     pallas_kernels.epoch_base_map_pallas cuda
==========================  ===================================  ========

The RRL line opacity (see ``csrc/rrl_maps.cu``)

    tau(c, x, z) = sum_y amp * Re w(x_c + i y_v) * (1 - exp(-(f_c + nu0) hkT))

has two more (the per-cell Voigt function is the Weideman-16 rational or a
3-term asymptotic series, as the Pallas kernels):

==========================  ===================================  ========
wrapper                     TPU kernel replaced                  route
==========================  ===================================  ========
``rrl_tiles``               pallas_kernels.rrl_tiles_pallas      cuda
                            and its fold segment_tile_maps
``rrl_cube``                pallas_kernels.rrl_cube_pallas       cuda
==========================  ===================================  ========

The two tile wrappers are one kernel templated on the number of bases.
They and ``rrl_tiles`` sum a tile position's tiles themselves, walking
them through the per-model permutation of :func:`segment_order`, and write
every map element once; ``epoch_tile_partials``, ``epoch_tile_partials2``
and ``rrl_tile_partials`` (the TPU kernels' per-tile layout) run the same
kernels with each tile its own position.
``rrl_cube`` is two launches: a pass that reads amp once and flags the row
blocks holding a jet cell (:func:`rrl_row_activity`), then the maps over
those blocks only.

The ordered emergent scan (see ``csrc/emergent_maps.cu``)

    I(x, z) = sum_y S e^{-tau_acc} (1 - e^{-dtau}),  tau_acc = dtau in front,

has three more, walking each (x, z) column from the observer's end (the
full-grid one streams its opacity base through the same ring, once for up
to ``EMERGENT_GROUP_FULL`` channels, and reads temp only where base != 0):

==========================  ===================================  ========
wrapper                     TPU kernel replaced                  route
==========================  ===================================  ========
``emergent_tile_partials``  pallas_kernels.emergent_ff_tiles     cuda
``emergent_ff_full``        pallas_kernels.emergent_ff_pallas    cuda
``transfer_scan_maps``      pallas_kernels.transfer_scan_pallas  cuda
==========================  ===================================  ========

The Faddeeva function w(x + iy) of ``ops/voigt.wofz`` (see
``csrc/voigt.cu``) has one more, which replaces no TPU kernel (XLA fuses
the JAX package's scheme); its wrapper takes CUDA tensors only, and
``ops/voigt._wofz_eval`` keeps the plain version for CPU tensors:

==========================  ===================================  ========
wrapper                     TPU kernel replaced                  route
==========================  ===================================  ========
``wofz_kernel``             none (voigt.wofz, fused by XLA)      cuda
==========================  ===================================  ========

The LTE channel stage of an RRL run (see ``csrc/rrl_flux.cu``), the line
and free-free flux maps from the line opacity maps, the 2-D continuum base
map and the channel scale, has one more, which also replaces no TPU kernel
(XLA fuses the stage in the JAX package); its plain version is
``ops/radtrans.rrl_flux_maps_lte``, and it has no backward (the fits keep
the eager chain):

==========================  ===================================  ========
wrapper                     TPU kernel replaced                  route
==========================  ===================================  ========
``rrl_flux_maps``           none (the channel stage, fused by    cuda
                            XLA)
==========================  ===================================  ========

Hogbom's CLEAN minor cycle (see ``csrc/hogbom.cu``), two launches an
iteration on a block of channels (the subtraction fused with the next peak
search, then the component), replaces no TPU kernel either (the JAX
package's loop is a ``lax.while_loop``); ``synthobs/imaging._hogbom``
drives it for CUDA tensors and takes its plain version,
``imaging._hogbom_plain`` (the eager step), for CPU tensors:

==========================  ===================================  ========
wrapper                     TPU kernel replaced                  route
==========================  ===================================  ========
``HogbomCycle``             none (imaging._hogbom, a             cuda
                            lax.while_loop in the JAX package)
==========================  ===================================  ========

Each wrapper takes CUDA tensors to its kernel and CPU tensors to the plain
PyTorch version beside it (same formula, ``torch.sum`` over y; the ordered
scans by an exclusive cumsum; the full-grid epoch version, like its
kernel, gives a cell with base = 0 no part in the sum even where its launch
time is not finite); any other device raises.  ``LAUNCHES`` counts kernel
launches per wrapper, under the TPU kernel's name.

The kernels are compiled at first use with ``nvcc`` (one process per
``csrc/*.cu`` source, all started together, each with the common
``NVCC_FLAGS`` and its own ``SOURCE_FLAGS``, then one link) into a shared
library with a plain C interface under ``rajepy_tpu_torch/_build/``
(rebuilt when any source, shared ``csrc/*.cuh`` header or flag changes)
and bound with ``ctypes``.  Nothing here
imports or builds anything CUDA-specific at import time.

Compaction: the jet silhouette covers a few percent of the cube, so the
epoch-independent cubes are cut once per model into the jet-occupied
(8, 64, 128) tiles (:func:`active_tiles`, :func:`gather_tiles`); the
plain versions of the epoch tile maps sum each tile over y and
:func:`reassemble_tiles` folds the (8, 128) partials into the (nx, nz) map
with ``index_add_``, as the TPU kernels' ``segment_sum`` does;
:func:`segment_tile_maps` is the same fold for per-channel partials (the
plain RRL maps).  The emergent
scan compacts the cubes flipped into observer order
(:func:`active_tiles_scan_order`), so that a segment's tiles are
consecutive and in LOS order; its kernel writes one (n_chan, bx, bz) map
per segment and :func:`scatter_tile_maps` places them on the image.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import constants as cnsts
from ..utils import profiling
from .physics import _BB_PREFACTOR_CBRT
from .voigt import _weideman_coeffs

# Compacted-tile dims (block_x, y_chunk, block_z), fixed in the CUDA source
TILE = (8, 64, 128)
MAX_BURSTS = 32

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {'epoch_base_map_tiles': 0, 'epoch_base_maps2_tiles': 0,
            'epoch_base_map_full': 0, 'rrl_tiles_pallas': 0,
            'rrl_cube_pallas': 0, 'emergent_ff_tiles': 0,
            'emergent_ff_pallas': 0, 'transfer_scan_pallas': 0,
            'wofz': 0, 'rrl_flux': 0, 'hogbom': 0}

# Weideman degree of the float32 RRL kernels: its truncation error (1.4e-7
# on |x| <= 8) already sits at the float32 roundoff floor
N_WEIDEMAN_RRL = 16
# Re w switches from the Weideman rational to the asymptotic series here
FAR_CUT = 8.0
# channels per lane of the RRL maps kernels (CPL in csrc/rrl_maps.cu): a
# block takes a group of RRL_CPL * lanes channels (rrl_lanes_log2), at most
# RRL_MAX_GROUP, whose sums fill 33 KB of its shared memory
RRL_CPL = 4
RRL_MAX_GROUP = 64
# channels a block of the channel-stage kernel (CB in csrc/rrl_flux.cu)
RRL_FLUX_CB = 64
# pixels a block of the Hogbom kernel scans for its peak (TILE in
# csrc/hogbom.cu)
HOGBOM_TILE = 2048
# (1, y, z) extent of the full-grid RRL kernel's row blocks (ROW_Y, ROW_Z)
RRL_ROW = (1, 64, 128)
# channels per thread of the emergent kernels (CPT_FULL and CPT_TILES in
# csrc/emergent_maps.cu); a block of the full-grid kernel takes up to
# EMERGENT_GROUP_FULL channels (GROUP_FULL), one warp per CPT_FULL of them,
# from one read of the opacity base; a block of the tile kernel has
# EMERGENT_TILE_WARPS warps (TWARPS), split into channel groups of
# EMERGENT_CPT_TILES channels times chunks of the tile's y
EMERGENT_CPT_FULL = 4
EMERGENT_GROUP_FULL = 64
EMERGENT_CPT_TILES = 4
EMERGENT_TILE_WARPS = 16
# z columns of a strip of the full-grid kernels (STRIP_W in csrc/stream.cuh)
# and strips per block of the epoch one (EPOCH_WARPS in csrc/epoch_maps.cu)
STRIP_W = 32
EPOCH_FULL_WARPS = 4
_MAX_GRID_YZ = 65535
_MAX_GRID_X = 2 ** 31 - 1
_SQRT_PI = 1.7724538509055159

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, 'csrc')
_BUILD_DIR = os.path.join(_PKG_DIR, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xptxas', '-v', '-Xcompiler', '-fPIC')
#: each source's own flags, after NVCC_FLAGS: the epoch and emergent
#: kernels keep the TPU's float32 operation order (no contracted
#: multiply-add), and the Faddeeva, channel-stage and Hogbom kernels the
#: eager chain's rounding of their plain versions; the RRL kernels contract
#: (two FMAs per Goertzel step)
SOURCE_FLAGS = {'epoch_maps.cu': ('-fmad=false',),
                'emergent_maps.cu': ('-fmad=false',),
                'hogbom.cu': ('-fmad=false',),
                'rrl_flux.cu': ('-fmad=false',),
                'rrl_maps.cu': (),
                'voigt.cu': ('-fmad=false',)}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------- #
# Launch-time packing
# --------------------------------------------------------------------------- #
def pack_offset_for(ts_min: float) -> float:
    """Packing offset for :func:`pack_launch_time` that keeps the packed
    magnitude |ts + offset| strictly positive IN FLOAT32 for every
    ts >= ts_min (the margin scales with |ts_min|: 1e-5 relative, ~2 f32
    ulps of headroom)."""
    ts_min = float(ts_min)
    return 1.0 + 1e-5 * abs(ts_min) - min(0.0, ts_min)


def pack_launch_time(ts: torch.Tensor, red: torch.Tensor,
                     dtype: torch.dtype = torch.float32,
                     offset: float = 1.0) -> torch.Tensor:
    """Pack launch time + jet side into one cube for the epoch kernels:
    +(ts + offset) on the blue side, -(ts + offset) on the red side.

    ``offset`` MUST exceed ``-min(ts)`` (travel times can be negative near
    the launch surface off-axis); every kernel unpacks
    ``|tss| - pack_offset`` with the same value."""
    ts1 = ts.to(dtype) + offset
    return torch.where(red, -ts1, ts1)


# --------------------------------------------------------------------------- #
# Tile compaction
# --------------------------------------------------------------------------- #
def _tile_grid(n: int, b: int) -> int:
    return -(-n // b)


def _index(a, device) -> torch.Tensor:
    """int64 index tensor on ``device`` from a numpy array or a tensor."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)


def _pad_to_tiles(cube: torch.Tensor, bx: int, yc: int, bz: int, fill):
    nx, ny, nz = cube.shape
    pads = ((-nx) % bx, (-ny) % yc, (-nz) % bz)
    if not any(pads):
        return cube
    out = cube.new_full((nx + pads[0], ny + pads[1], nz + pads[2]), fill)
    out[:nx, :ny, :nz] = cube
    return out


def _tile_view(cube, bx, yc, bz, fill):
    """(nX, nY, nZ, bx, yc, bz) strided view of the padded cube."""
    p = _pad_to_tiles(cube, bx, yc, bz, fill)
    nx, ny, nz = p.shape
    return p.reshape(nx // bx, bx, ny // yc, yc, nz // bz,
                     bz).permute(0, 2, 4, 1, 3, 5)


def _tile_activity(inside: torch.Tensor, block_x: int = 8,
                   block_z: int = 128, y_chunk: int = 64) -> torch.Tensor:
    """(nX, nY, nZ) bool: which (block_x, y_chunk, block_z) tiles contain
    any jet cell."""
    t = _tile_view(inside, block_x, y_chunk, block_z, False)
    return t.flatten(3).any(dim=3)


def active_tiles(inside: torch.Tensor, block_x: int = 8, block_z: int = 128,
                 y_chunk: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Flat ids of jet-occupied tiles plus their (x, z)-tile segment ids
    for the collapsed-map reassembly, as int32 numpy arrays of shape
    (n_act,); empty when the grid holds no jet cells."""
    act = _tile_activity(inside, block_x, block_z, y_chunk).cpu().numpy()
    n_xt, n_yt, n_zt = act.shape
    ids = np.flatnonzero(act.reshape(-1)).astype(np.int32)
    i = ids // (n_yt * n_zt)
    k = ids % n_zt
    seg = (i * n_zt + k).astype(np.int32)
    return ids, seg


def gather_tiles(cube: torch.Tensor, ids, block_x: int = 8,
                 block_z: int = 128, y_chunk: int = 64,
                 fill=0.0) -> torch.Tensor:
    """(n_act, block_x, y_chunk, block_z) contiguous compacted copy of
    ``cube`` at the active tile ids (one gather, once per model; the
    padded cube is never copied whole)."""
    t = _tile_view(cube, block_x, y_chunk, block_z, fill)
    n_yt, n_zt = t.shape[1], t.shape[2]
    ids = _index(ids, cube.device)
    return t[ids // (n_yt * n_zt), (ids // n_zt) % n_yt,
             ids % n_zt].contiguous()


def reassemble_tiles(parts: torch.Tensor, seg: torch.Tensor, nx: int,
                     nz: int) -> torch.Tensor:
    """Fold (n_act, bx, bz) per-tile partial maps into the (nx, nz) map:
    a segment sum over the tiles' (x, z) positions (``seg``, int64 on the
    parts' device).  On CUDA ``index_add_`` adds with atomics, so the order
    of a segment's y tiles, and the last bits of its sum, vary between
    runs."""
    _, bx, bz = parts.shape
    n_xt = _tile_grid(nx, bx)
    n_zt = _tile_grid(nz, bz)
    m = parts.new_zeros((n_xt * n_zt, bx, bz))
    m.index_add_(0, seg, parts)
    m = m.reshape(n_xt, n_zt, bx, bz).permute(0, 2, 1, 3)
    return m.reshape(n_xt * bx, n_zt * bz)[:nx, :nz]


def active_tiles_scan_order(inside_flipped: torch.Tensor, block_x: int = 8,
                            block_z: int = 128, y_chunk: int = 64):
    """Jet-occupied tiles of the ordered emergent scan, once per model
    (pallas_kernels.active_tiles_scan_order).

    ``inside_flipped`` is already flipped along y into observer order (y=0
    nearest the observer).  Tiles are sorted by (x-tile, z-tile) segment,
    then by y, so that a segment's tiles are consecutive and in LOS order.
    Returns int32 numpy ``(ids, seg, it, kt)``: flat tile ids into the
    padded tile grid, the dense [0, n_seg) segment of each tile (non-
    decreasing), and each segment's (x, z) tile coordinates."""
    act = _tile_activity(inside_flipped, block_x, block_z,
                         y_chunk).cpu().numpy()
    n_xt, n_yt, n_zt = act.shape
    ids = np.flatnonzero(act.reshape(-1)).astype(np.int32)
    i = ids // (n_yt * n_zt)
    j = (ids // n_zt) % n_yt
    k = ids % n_zt
    order = np.lexsort((j, k, i))         # primary i, then k, then j
    ids, i, j, k = ids[order], i[order], j[order], k[order]
    uniq, seg = np.unique(i * n_zt + k, return_inverse=True)
    return (ids, seg.astype(np.int32), (uniq // n_zt).astype(np.int32),
            (uniq % n_zt).astype(np.int32))


def segment_starts(seg, n_seg: int) -> np.ndarray:
    """(n_seg + 1,) int32 offsets: segment s holds tiles seg_start[s] ..
    seg_start[s + 1] - 1 of the scan-ordered tiles.  The tile kernel reads
    them where the TPU kernel detects a segment's first tile inside its
    sequential grid."""
    counts = np.bincount(np.asarray(seg, dtype=np.int64), minlength=n_seg)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def segment_order(seg, n_seg: int) -> Tuple[np.ndarray, np.ndarray]:
    """The RRL maps kernel's walk over compacted tiles, once per model:
    int32 numpy ``(order, seg_start)``.  Segment s (the (x, z) tile
    position s // n_zt, s % n_zt, of ``n_seg`` = n_xt * n_zt) holds tiles
    ``order[seg_start[s]] .. order[seg_start[s + 1] - 1]``, in their
    compacted order; a position with no tile has an empty range.  The tiles
    themselves stay in :func:`active_tiles` order, which the epoch kernels
    share."""
    seg = np.asarray(seg, dtype=np.int64)
    order = np.argsort(seg, kind='stable').astype(np.int32)
    return order, segment_starts(seg, n_seg)


def tile_segments(order: torch.Tensor, seg_start: torch.Tensor
                  ) -> torch.Tensor:
    """Each tile's segment id (int64, on ``order``'s device), from
    :func:`segment_order`'s ``(order, seg_start)``."""
    counts = torch.diff(seg_start.to(torch.int64))
    ids = torch.arange(counts.numel(), device=order.device)
    seg = torch.empty(order.numel(), dtype=torch.int64, device=order.device)
    seg[order.to(torch.int64)] = torch.repeat_interleave(ids, counts)
    return seg


def scatter_tile_maps(parts: torch.Tensor, it, kt, n_xt: int, n_zt: int,
                      nx: int, nz: int) -> torch.Tensor:
    """(n_seg, n_chan, bx, bz) per-segment maps -> (n_chan, nx, nz), zero
    where no segment exists, i.e. no jet along that line of sight
    (pallas_kernels.scatter_tile_maps).  ``it``/``kt`` are each segment's
    (x, z) tile coordinates."""
    _, n_chan, bx, bz = parts.shape
    grid = parts.new_zeros((n_chan, n_xt, n_zt, bx, bz))
    grid[:, _index(it, parts.device), _index(kt, parts.device)] = \
        parts.transpose(0, 1)
    m = grid.permute(0, 1, 3, 2, 4).reshape(n_chan, n_xt * bx, n_zt * bz)
    return m[:, :nx, :nz]


# --------------------------------------------------------------------------- #
# Plain PyTorch versions (the CPU path, and the reference on the card)
# --------------------------------------------------------------------------- #
def _chi_plain(tss, t: float, bursts: Sequence, pack_offset: float):
    """Burst factor from packed launch times, in tss's dtype: the Pallas
    kernels' formula and order."""
    lt = t - (tss.abs() - pack_offset)
    red = tss < 0.0
    blue = torch.logical_not(red)
    chi = torch.ones_like(lt)
    for t0, inv2s2, amp, is_red in bursts:
        g = amp * torch.exp(-(lt - t0) ** 2 * inv2s2)
        chi = chi + torch.where(red if is_red else blue, g,
                                torch.zeros_like(g))
    return chi


def epoch_tile_partials_plain(base_t, tss_t, t: float, bursts: Sequence,
                              pack_offset: float = 1.0) -> torch.Tensor:
    """(n_act, bx, bz) partial sums sum_y base * chi * chi per tile."""
    chi = _chi_plain(tss_t, t, bursts, pack_offset)
    return torch.sum(base_t * chi * chi, dim=2)


def epoch_tile_partials2_plain(a_t, b_t, tss_t, t: float, bursts: Sequence,
                               pack_offset: float = 1.0):
    """Dual-base partials: one chi for both bases."""
    chi = _chi_plain(tss_t, t, bursts, pack_offset)
    chi2 = chi * chi
    return torch.sum(a_t * chi2, dim=2), torch.sum(b_t * chi2, dim=2)


def epoch_base_map_tiles_plain(base_t, tss_t, seg, t, bursts, nx: int,
                               nz: int, pack_offset: float = 1.0):
    """Plain version of :func:`epoch_base_map_tiles`."""
    parts = epoch_tile_partials_plain(base_t, tss_t, t, bursts, pack_offset)
    return reassemble_tiles(parts, seg, nx, nz)


def epoch_base_maps2_tiles_plain(a_t, b_t, tss_t, seg, t, bursts, nx: int,
                                 nz: int, pack_offset: float = 1.0):
    """Plain version of :func:`epoch_base_maps2_tiles`."""
    pa, pb = epoch_tile_partials2_plain(a_t, b_t, tss_t, t, bursts,
                                        pack_offset)
    return reassemble_tiles(pa, seg, nx, nz), reassemble_tiles(pb, seg, nx,
                                                              nz)


def epoch_base_map_full_plain(a, ts_signed, t, bursts,
                              pack_offset: float = 1.0):
    """Plain version of :func:`epoch_base_map_full`.  As in the kernel, a
    cell with a = 0 adds exactly 0 even where its launch time is not
    finite."""
    chi = _chi_plain(ts_signed, t, bursts, pack_offset)
    return torch.sum(torch.where(a != 0, a * chi * chi, torch.zeros_like(a)),
                     dim=1)


def segment_tile_maps(parts: torch.Tensor, seg: torch.Tensor, nx: int,
                      nz: int) -> torch.Tensor:
    """Fold (n_act, n_chan, bx, bz) per-tile partials into (n_chan, nx, nz)
    maps: a segment sum over the tiles' (x, z) positions with
    ``index_add_`` over the tile axis (pallas_kernels.segment_tile_maps),
    as :func:`reassemble_tiles` for one channel."""
    _, n_chan, bx, bz = parts.shape
    n_xt = _tile_grid(nx, bx)
    n_zt = _tile_grid(nz, bz)
    m = parts.new_zeros((n_xt * n_zt, n_chan, bx, bz))
    m.index_add_(0, seg, parts)
    m = m.reshape(n_xt, n_zt, n_chan, bx, bz).permute(2, 0, 3, 1, 4)
    return m.reshape(n_chan, n_xt * bx, n_zt * bz)[:, :nx, :nz]


def voigt_re_far(x, y):
    """Re w(x + iy) by the 3-term asymptotic series
    w(z) ~ i/(sqrt(pi) z) sum_k (2k-1)!!/(2 z^2)^k, for |x| + y > 8
    (pallas_kernels._voigt_re_far)."""
    inv = 1.0 / (x * x + y * y)
    wr2 = 0.5 * (x * x - y * y) * inv * inv
    wi2 = -x * y * inv * inv
    sr = wr2 * 15.0 + 3.0
    si = wi2 * 15.0
    sr, si = sr * wr2 - si * wi2 + 1.0, sr * wi2 + si * wr2
    sr, si = sr * wr2 - si * wi2 + 1.0, sr * wi2 + si * wr2
    return (y * sr - x * si) * inv / _SQRT_PI


def voigt_re_weideman(x, y):
    """Re w(x + iy) by the Weideman rational alone, for |x| + y <= 8: the
    real-coefficient p(Z) at Z = (L+iz)/(L-iz) by the Goertzel recurrence
    b_k = c_k + 2 Re(Z) b_{k+1} - |Z|^2 b_{k+2}, p = b_0 - b_1 conj(Z)
    (pallas_kernels._voigt_re_weideman)."""
    ell, coeffs = _weideman_coeffs(N_WEIDEMAN_RRL)
    ell = float(ell)
    dr = ell + y
    di = -x
    nr = ell - y
    ni = x
    inv_den = 1.0 / (dr * dr + di * di)
    zr = (nr * dr + ni * di) * inv_den
    zi = (ni * dr - nr * di) * inv_den
    r = 2.0 * zr
    s = zr * zr + zi * zi
    b1 = torch.zeros_like(zr)
    b2 = torch.zeros_like(zr)
    for c in coeffs:           # highest power first
        b1, b2 = float(c) + r * b1 - s * b2, b1
    pr = b1 - b2 * zr
    pi = b2 * zi
    inv_r = dr * inv_den
    inv_i = -di * inv_den
    inv2_r = inv_r * inv_r - inv_i * inv_i
    inv2_i = 2.0 * inv_r * inv_i
    return 2.0 * (pr * inv2_r - pi * inv2_i) + inv_r / _SQRT_PI


def voigt_re_mixed(x, y):
    """Re w(x + iy) per cell: the Weideman rational where |x| + y <= 8, the
    asymptotic series beyond (pallas_kernels._voigt_re_mixed)."""
    w_re = voigt_re_weideman(x, y)
    far = (x.abs() + y) > FAR_CUT
    ten = torch.full_like(x, 10.0)
    xf = torch.where(far, x, ten)   # keep near cells out of the
    yf = torch.where(far, y, ten)   # asymptotic's singular region
    return torch.where(far, voigt_re_far(xf, yf), w_re)


def _rrl_cells_plain(fo, amp, rest, scale, yv, hkt, nu0: float):
    """Per-cell amp * Re w * (1 - e^{-(f + nu0) hkT}) at channel offset fo."""
    x = (fo - rest) * scale
    stim = -torch.expm1(-((fo + nu0) * hkt))
    return amp * voigt_re_mixed(x, yv) * stim


def rrl_tile_partials_plain(freqs_off, amp_t, rest_t, scale_t, yv_t, hkt_t,
                            nu0: float) -> torch.Tensor:
    """Plain version of :func:`rrl_tile_partials`: (n_act, n_chan, bx, bz)
    per-tile sums over y, one channel at a time."""
    if freqs_off.numel() == 0:
        return amp_t.new_zeros((amp_t.shape[0], 0, TILE[0], TILE[2]))
    return torch.stack([
        torch.sum(_rrl_cells_plain(fo, amp_t, rest_t, scale_t, yv_t, hkt_t,
                                   nu0), dim=2) for fo in freqs_off], dim=1)


def rrl_tiles_plain(freqs_off, amp_t, rest_t, scale_t, yv_t, hkt_t,
                    nu0: float, order, seg_start, nx: int,
                    nz: int) -> torch.Tensor:
    """Plain version of :func:`rrl_tiles`: the per-tile partials folded by
    :func:`segment_tile_maps`."""
    parts = rrl_tile_partials_plain(freqs_off, amp_t, rest_t, scale_t, yv_t,
                                    hkt_t, nu0)
    return segment_tile_maps(parts, tile_segments(order, seg_start), nx, nz)


def rrl_row_activity_plain(amp: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rrl_row_activity`."""
    _, yc, zc = RRL_ROW
    return _tile_activity(amp != 0, 1, zc, yc)


def rrl_cube_plain(freqs_off, amp, rest, scale, yv, hkt,
                   nu0: float) -> torch.Tensor:
    """Plain version of :func:`rrl_cube`: (n_chan, nx, nz) sums over y of
    the full grid, one channel at a time."""
    if freqs_off.numel() == 0:
        return amp.new_zeros((0, amp.shape[0], amp.shape[2]))
    return torch.stack([
        torch.sum(_rrl_cells_plain(fo, amp, rest, scale, yv, hkt, nu0),
                  dim=1) for fo in freqs_off])


def exclusive_cumsum(d: torch.Tensor, dim: int) -> torch.Tensor:
    """Optical depth in front of each cell along ``dim``: the inclusive
    cumsum shifted by one cell, so that no large total is subtracted back
    out (at 3e8 Hz the flagship's tau reaches the hundreds)."""
    c = torch.cumsum(d, dim)
    n = d.shape[dim]
    return torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)),
                      c.narrow(dim, 0, n - 1)], dim)


def transfer_scan_maps_plain(source, dtau, observer_near_y0: bool = False):
    """Plain version of :func:`transfer_scan_maps`: ``(I, tau_total)``."""
    from .radtrans import transfer_scan   # radtrans imports this module
    return (transfer_scan(source, dtau, observer_near_y0),
            torch.sum(dtau, dim=1))


def emergent_ff_full_plain(cnu, hnuk, tau_scale, temp, dtau_base,
                           observer_near_y0: bool = False):
    """Plain version of :func:`emergent_ff_full`: (n_chan, nx, nz) maps of
    I and tau_total, one channel at a time (so a 512^3 call holds a few
    cube-sized temporaries, not n_chan of them)."""
    ints, taus = [], []
    for c in range(cnu.shape[0]):
        src = cnu[c] / torch.expm1(hnuk[c] / temp)
        i, tau = transfer_scan_maps_plain(src, dtau_base * tau_scale[c],
                                          observer_near_y0)
        ints.append(i)
        taus.append(tau)
    if not ints:
        empty = temp.new_zeros((0, temp.shape[0], temp.shape[2]))
        return empty, empty.clone()
    return torch.stack(ints), torch.stack(taus)


def emergent_tile_partials_plain(cnu, hnuk, tau_scale, temp_t, a_t, tss_t,
                                 seg_start, t: float, bursts: Sequence,
                                 pack_offset: float = 1.0):
    """Plain version of :func:`emergent_tile_partials`: per-segment maps of
    I and tau_total, (n_seg, n_chan, bx, bz), for tiles of any shape.

    Vectorised over tiles and channels: the optical depth in front of a
    cell is its tile's exclusive cumsum along y plus the totals of the
    segment's earlier tiles, carried by a loop over position in the
    segment (at most ny / y_chunk steps, all segments at once)."""
    starts = np.asarray(torch.as_tensor(seg_start).cpu(), dtype=np.int64)
    n_seg = starts.size - 1
    n_act, bx, _, bz = a_t.shape
    dev = a_t.device
    chan = (None, slice(None), None, None, None)
    chi = _chi_plain(tss_t, t, bursts, pack_offset)
    d = (a_t * chi * chi)[:, None] * tau_scale[chan]
    emit = cnu[chan] / torch.expm1(hnuk[chan] / temp_t[:, None]) * \
        -torch.expm1(-d)
    tau_in = exclusive_cumsum(d, 3)
    tot = torch.sum(d, dim=3)                  # (n_act, n_chan, bx, bz)
    seg = np.repeat(np.arange(n_seg), np.diff(starts))
    pos = np.arange(n_act) - starts[seg]
    front = torch.zeros_like(tot)              # tau of the earlier tiles
    for k in range(1, int(pos.max(initial=0)) + 1):
        idx = _index(np.flatnonzero(pos == k), dev)
        front[idx] = front[idx - 1] + tot[idx - 1]
    parts = torch.sum(emit * torch.exp(-(tau_in + front[:, :, :, None])),
                      dim=3)
    inten = parts.new_zeros((n_seg,) + parts.shape[1:])
    inten.index_add_(0, _index(seg, dev), parts)
    last = _index(starts[1:] - 1, dev)
    return inten, front[last] + tot[last]


# --------------------------------------------------------------------------- #
# Build and bind the CUDA library
# --------------------------------------------------------------------------- #
# side index of struct Bursts (SIDE_BLUE, SIDE_RED in bursts.cuh)
SIDE_BLUE, SIDE_RED = 0, 1


class _Bursts(ctypes.Structure):
    """The epoch and emergent kernels' burst list split by side (index
    ``SIDE_BLUE`` or ``SIDE_RED``), each side's bursts in their original
    order as (t0, 1/(2 sigma^2), amplitude, unused); mirrors
    ``struct Bursts`` in bursts.cuh.  Passed to the C entry points by
    pointer; the kernels get it by value."""
    _fields_ = [('n', ctypes.c_int * 2),
                ('p', ((ctypes.c_float * 4) * MAX_BURSTS) * 2)]


class _Weideman(ctypes.Structure):
    """By-value Weideman-16 scale and coefficients (highest power first);
    mirrors ``struct Weideman`` in rrl_maps.cu."""
    _fields_ = [('ell', ctypes.c_float),
                ('c', ctypes.c_float * N_WEIDEMAN_RRL)]


@functools.lru_cache(maxsize=1)
def _weideman_struct() -> _Weideman:
    """The RRL kernels' constants, made once (an FFT on the host)."""
    ell, coeffs = _weideman_coeffs(N_WEIDEMAN_RRL)
    w = _Weideman()
    w.ell = float(ell)
    for i, c in enumerate(coeffs):
        w.c[i] = float(c)
    return w


class _WofzCoeffs64(ctypes.Structure):
    """The float64 Faddeeva kernel's Weideman-128 scale and coefficients
    (highest power first); mirrors ``WofzCoeffs64`` in voigt.cu."""
    _fields_ = [('ell', ctypes.c_double), ('a', ctypes.c_double * 128)]


class _WofzCoeffs32(ctypes.Structure):
    """The float32 Faddeeva kernel's Weideman-32 scale and coefficients;
    mirrors ``WofzCoeffs32`` in voigt.cu."""
    _fields_ = [('ell', ctypes.c_float), ('a', ctypes.c_float * 32)]


@functools.lru_cache(maxsize=2)
def _wofz_struct(dtype: torch.dtype):
    """The Faddeeva kernel's constants for ``dtype``, made once: the
    coefficients of ``ops/voigt._wofz_core`` at that dtype's degree, each
    rounded to the dtype as the plain version's scalars are."""
    cls, n = ((_WofzCoeffs64, 128) if dtype == torch.float64 else
              (_WofzCoeffs32, 32))
    ell, coeffs = _weideman_coeffs(n)
    w = cls()
    w.ell = float(ell)
    for i, c in enumerate(coeffs):
        w.a[i] = float(c)
    return w


class _RrlFluxConsts(ctypes.Structure):
    """The channel-stage kernel's physical constants, each rounded to
    float32 as the plain version's scalars are; mirrors ``RrlFluxConsts``
    in rrl_flux.cu."""
    _fields_ = [('bb_cbrt', ctypes.c_float), ('h_cgs', ctypes.c_float),
                ('k_cgs', ctypes.c_float), ('k_b', ctypes.c_float),
                ('c2', ctypes.c_float), ('fscale', ctypes.c_float)]


def _bursts_struct(bursts: Sequence) -> _Bursts:
    if len(bursts) > MAX_BURSTS:
        raise ValueError(f"the epoch kernels take at most {MAX_BURSTS} "
                         f"bursts, got {len(bursts)}")
    b = _Bursts()
    for t0, inv2s2, amp, is_red in bursts:
        side = SIDE_RED if is_red else SIDE_BLUE
        slot = b.p[side][b.n[side]]
        slot[0], slot[1], slot[2] = t0, inv2s2, amp
        b.n[side] += 1
    return b


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels are built from "
                       "csrc/*.cu at first use on a CUDA machine")


def sources(csrc: str = _CSRC) -> list:
    """The CUDA compilation units of the library (``csrc/*.cu``), in a
    fixed order."""
    return sorted(glob.glob(os.path.join(csrc, '*.cu')))


def build_inputs(csrc: str = _CSRC) -> list:
    """Every file under ``csrc`` that the build reads: the sources and the
    headers they include (``*.cuh``), in a fixed order."""
    return sorted(sources(csrc) + glob.glob(os.path.join(csrc, '*.cuh')))


def nvcc_flags(src: str) -> tuple:
    """The flags one source is compiled with: ``NVCC_FLAGS`` and its own
    ``SOURCE_FLAGS`` entry (every source must have one)."""
    name = os.path.basename(src)
    if name not in SOURCE_FLAGS:
        raise KeyError(f"{name}: no entry in kernels.SOURCE_FLAGS")
    return NVCC_FLAGS + tuple(SOURCE_FLAGS[name])


def library_path(csrc: str = _CSRC) -> str:
    """Where the build for the current sources, headers and flags lives."""
    h = hashlib.sha256()
    for src in build_inputs(csrc):
        h.update(os.path.basename(src).encode())
        with open(src, 'rb') as f:
            h.update(f.read())
        if src.endswith('.cu'):
            h.update(' '.join(nvcc_flags(src)).encode())
    return os.path.join(_BUILD_DIR, f'libkernels_{h.hexdigest()[:16]}.so')


def build_log() -> str:
    """The compiler's report (ptxas registers, shared memory and spills of
    every kernel) of the current library's build, kept beside it."""
    path = library_path()[:-len('.so')] + '.log'
    if not os.path.exists(path):
        return ''
    with open(path) as f:
        return f.read()


def build() -> str:
    """Compile every csrc/*.cu into one shared library unless a build of
    these sources exists; returns the library path.  One ``nvcc`` per
    source runs at once, then one link.  The compiler's report is kept
    beside the library (:func:`build_log`)."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmpdir, os.path.basename(src) + '.o')
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *nvcc_flags(src), '-c', '-o', obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"{os.path.basename(src)}:\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src} ({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(tmpdir, 'lib.so')
        res = subprocess.run([nvcc, '-shared', '-o', tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        with open(path[:-len('.so')] + '.log', 'w') as f:
            f.write('\n'.join(logs))
        os.replace(tmp, path)
    return path


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        bp = ctypes.POINTER(_Bursts)    # a struct instance goes by pointer
        lib.epoch_maps1.argtypes = [p] * 5 + [i] * 4 + [f, f, bp, p]
        lib.epoch_maps2.argtypes = [p] * 7 + [i] * 4 + [f, f, bp, p]
        lib.burst_chi_probe.argtypes = [p, p, i, f, f, bp, p]
        lib.epoch_full.argtypes = [p, p, p, i, i, i, f, f, bp, p]
        lib.rrl_tiles.argtypes = [p] * 9 + [i] * 6 + [f, _Weideman, p]
        lib.rrl_activity.argtypes = [p, p, i, i, i, p]
        lib.rrl_cube.argtypes = [p] * 8 + [i] * 5 + [f, _Weideman, p]
        lib.transfer_scan.argtypes = [p] * 4 + [i, i, i, i, p]
        lib.emergent_full.argtypes = [p] * 7 + [i, i, i, i, i, p]
        lib.emergent_tiles.argtypes = [p] * 9 + [i, i, i, f, f, bp, p]
        lib.wofz_f64.argtypes = [p] * 4 + [ctypes.c_size_t,
                                           ctypes.POINTER(_WofzCoeffs64), p]
        lib.wofz_f32.argtypes = [p] * 4 + [ctypes.c_size_t,
                                           ctypes.POINTER(_WofzCoeffs32), p]
        lib.rrl_flux.argtypes = [p] * 7 + [i] * 4 + [
            ctypes.POINTER(_RrlFluxConsts), p]
        lib.hogbom_update_peak.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.hogbom_component.argtypes = [p] * 9 + [i] * 3 + [
            ctypes.c_double, p]
        for fn in (lib.epoch_maps1, lib.epoch_maps2, lib.burst_chi_probe,
                   lib.epoch_full,
                   lib.rrl_tiles, lib.rrl_activity, lib.rrl_cube,
                   lib.transfer_scan, lib.emergent_full,
                   lib.emergent_tiles, lib.wofz_f64, lib.wofz_f32,
                   lib.rrl_flux, lib.hogbom_update_peak,
                   lib.hogbom_component):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_cuda(name: str, tensors, shape) -> None:
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {x.device} and {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                            f"{x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _raise_if_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{err}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _device_kind(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ('cuda', 'cpu'):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


# --------------------------------------------------------------------------- #
# Wrappers
# --------------------------------------------------------------------------- #
def _epoch_tile_maps(name, bases, tss_t, seg, t, bursts, nx, nz,
                     pack_offset, walk) -> torch.Tensor:
    """(len(bases), nx, nz) maps of the epoch tile kernel for one or two
    bases on CUDA tensors (``epoch_maps1``/``epoch_maps2``, the two
    instantiations of one kernel): the walk given, or :func:`segment_order`
    of ``seg`` made on the host."""
    n_act = bases[0].shape[0]
    dev = bases[0].device
    _check_cuda(name, (*bases, tss_t), (n_act,) + TILE)
    n_xt, n_zt = _tile_grid(nx, TILE[0]), _tile_grid(nz, TILE[2])
    if walk is None:
        walk = tuple(torch.as_tensor(w, device=dev) for w in segment_order(
            _index(seg, 'cpu').numpy(), n_xt * n_zt))
    order, seg_start = walk
    _check_index(name, order, n_act, dev)
    _check_index(name, seg_start, n_xt * n_zt + 1, dev)
    if n_xt * n_zt * TILE[0] > _MAX_GRID_X:
        raise ValueError(f"{name}: {n_xt} x {n_zt} tile positions exceed "
                         f"the launch grid")
    out = torch.empty((len(bases), nx, nz), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        lib = _lib()
        launch = lib.epoch_maps1 if len(bases) == 1 else lib.epoch_maps2
        err = launch(*(x.data_ptr() for x in bases), tss_t.data_ptr(),
                     order.data_ptr(), seg_start.data_ptr(),
                     *(m.data_ptr() for m in out), n_xt, n_zt, nx, nz,
                     float(t), float(pack_offset), _bursts_struct(bursts),
                     _stream(dev))
    _raise_if_error(name, err)
    LAUNCHES[name] += 1
    return out


def _identity_walk(n_act: int, dev):
    """The walk that makes each of ``n_act`` tiles its own tile position
    (a column of n_act x tiles): the kernels' per-tile partials."""
    ident = torch.arange(n_act + 1, dtype=torch.int32, device=dev)
    return ident[:-1], ident


def epoch_tile_partials(base_t, tss_t, t: float, bursts: Sequence,
                        pack_offset: float = 1.0) -> torch.Tensor:
    """(n_act, 8, 128) per-tile partials sum_y base * chi^2 of compacted
    (n_act, 8, 64, 128) tiles, the layout of
    pallas_kernels.epoch_base_map_tiles before its fold: for CUDA tensors
    the :func:`epoch_base_map_tiles` kernel with every tile its own tile
    position, for CPU tensors the plain version."""
    if _device_kind(base_t, 'epoch_base_map_tiles') == 'cpu':
        return epoch_tile_partials_plain(base_t, tss_t, t, bursts,
                                         pack_offset)
    n_act = base_t.shape[0]
    m = epoch_base_map_tiles(base_t, tss_t, None, t, bursts, n_act * TILE[0],
                             TILE[2], pack_offset,
                             walk=_identity_walk(n_act, base_t.device))
    return m.reshape(n_act, TILE[0], TILE[2])


def epoch_base_map_tiles(base_t, tss_t, seg, t: float, bursts: Sequence,
                         nx: int, nz: int, pack_offset: float = 1.0,
                         walk=None) -> torch.Tensor:
    """LOS-collapsed (nx, nz) map sum_y base * chi(t - ts)^2 over
    COMPACTED tiles (counterpart of pallas_kernels.epoch_base_map_tiles
    and its fold): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.

    Args:
      base_t: (n_act, 8, 64, 128) compacted epoch-independent base
      tss_t:  (n_act, 8, 64, 128) compacted packed launch time/side
              (gathered with fill=1.0)
      seg:    (n_act,) int64 (x, z)-tile segment ids (from active_tiles)
      t:      model time [s]
      bursts: (t0, 1/(2 sigma^2), rel_amp, is_red) per burst
      walk:   :func:`segment_order`'s ``(order, seg_start)`` of ``seg``

    The kernel is :func:`epoch_base_maps2_tiles`' with one base: it walks
    each tile position's tiles and writes every map element once (0 where
    no tile lies on the line of sight), in the same summation order, so
    its map equals that kernel's map of the same base bit for bit, and two
    calls give the same bits.  A model passes the walk it cached with its
    tiles; without one, the CUDA path derives it from ``seg`` on the host.
    The plain version takes ``seg``."""
    name = 'epoch_base_map_tiles'
    if _device_kind(base_t, name) == 'cpu':
        return epoch_base_map_tiles_plain(base_t, tss_t, seg, t, bursts, nx,
                                          nz, pack_offset)
    return _epoch_tile_maps(name, (base_t,), tss_t, seg, t, bursts, nx, nz,
                            pack_offset, walk)[0]


def epoch_tile_partials2(a_t, b_t, tss_t, t: float, bursts: Sequence,
                         pack_offset: float = 1.0):
    """Dual-base (n_act, 8, 128) per-tile partials (sum_y a*chi^2,
    sum_y b*chi^2) of compacted tiles, the layout of
    pallas_kernels.epoch_base_maps2_tiles before its fold: for CUDA tensors
    the :func:`epoch_base_maps2_tiles` kernel with every tile its own tile
    position, for CPU tensors the plain version."""
    if _device_kind(a_t, 'epoch_base_maps2_tiles') == 'cpu':
        return epoch_tile_partials2_plain(a_t, b_t, tss_t, t, bursts,
                                          pack_offset)
    n_act = a_t.shape[0]
    maps = epoch_base_maps2_tiles(a_t, b_t, tss_t, None, t, bursts,
                                  n_act * TILE[0], TILE[2], pack_offset,
                                  walk=_identity_walk(n_act, a_t.device))
    return tuple(m.reshape(n_act, TILE[0], TILE[2]) for m in maps)


def epoch_base_maps2_tiles(a_t, b_t, tss_t, seg, t: float,
                           bursts: Sequence, nx: int, nz: int,
                           pack_offset: float = 1.0, walk=None):
    """Both collapsed (nx, nz) maps (sum_y a*chi^2, sum_y b*chi^2) in ONE
    pass over compacted (n_act, 8, 64, 128) tiles: one tss stream and one
    chi evaluation serve both bases (counterpart of
    pallas_kernels.epoch_base_maps2_tiles and its fold).  The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.

    ``seg`` and ``walk`` are :func:`epoch_base_map_tiles`' (``seg_start``
    of n_xt * n_zt + 1 entries), and so is the kernel, with two bases: each
    map is written once, summed in a fixed order, and equals that
    function's map of its base bit for bit."""
    name = 'epoch_base_maps2_tiles'
    if _device_kind(a_t, name) == 'cpu':
        return epoch_base_maps2_tiles_plain(a_t, b_t, tss_t, seg, t, bursts,
                                            nx, nz, pack_offset)
    out = _epoch_tile_maps(name, (a_t, b_t), tss_t, seg, t, bursts, nx, nz,
                           pack_offset, walk)
    return out[0], out[1]


def burst_chi_probe(tss, t: float, bursts: Sequence,
                    pack_offset: float = 1.0) -> torch.Tensor:
    """The burst factor chi of every element of a float32 CUDA tensor of
    packed launch times, by ``burst_chi`` of csrc/bursts.cuh alone (the
    kernels' own evaluation); on a CPU tensor, :func:`_chi_plain`.  A
    measurement aid: no model path calls it, and it counts no launch."""
    if _device_kind(tss, 'burst_chi_probe') == 'cpu':
        return _chi_plain(tss, t, bursts, pack_offset)
    _check_cuda('burst_chi_probe', (tss,), tss.shape)
    out = torch.empty_like(tss)
    if out.numel() == 0:
        return out
    with torch.cuda.device(tss.device):
        err = _lib().burst_chi_probe(tss.data_ptr(), out.data_ptr(),
                                     tss.numel(), float(t),
                                     float(pack_offset),
                                     _bursts_struct(bursts),
                                     _stream(tss.device))
    _raise_if_error('burst_chi_probe', err)
    return out


def epoch_base_map_full(a, ts_signed, t: float, bursts: Sequence,
                        pack_offset: float = 1.0) -> torch.Tensor:
    """(nx, nz) map sum_y a * chi(t - ts)^2 over the FULL (nx, ny, nz) grid
    (counterpart of pallas_kernels.epoch_base_map_pallas): the model's
    branch when the grid holds no jet cell, so no tile is active.  The
    kernel reads ``a`` whole and ``ts_signed`` only where a != 0 (a cell
    with a = 0 adds exactly 0); it takes any grid shape and any contiguous
    view, 16-byte aligned or not."""
    name = 'epoch_base_map_full'
    if _device_kind(a, name) == 'cpu':
        return epoch_base_map_full_plain(a, ts_signed, t, bursts,
                                         pack_offset)
    if a.dim() != 3:
        raise ValueError(f"{name}: expected an (nx, ny, nz) cube, got "
                         f"shape {tuple(a.shape)}")
    nx, ny, nz = a.shape
    _check_cuda(name, (a, ts_signed), (nx, ny, nz))
    if nx * _tile_grid(nz, STRIP_W * EPOCH_FULL_WARPS) > _MAX_GRID_X:
        raise ValueError(f"{name}: {nx} x {nz} columns exceed the launch "
                         f"grid")
    b = _bursts_struct(bursts)
    out = torch.empty((nx, nz), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        err = _lib().epoch_full(a.data_ptr(), ts_signed.data_ptr(),
                                out.data_ptr(), nx, ny, nz, float(t),
                                float(pack_offset), b, _stream(a.device))
    _raise_if_error(name, err)
    LAUNCHES[name] += 1
    return out


def _check_freqs(name: str, freqs_off, dev) -> int:
    if freqs_off.device != dev:
        raise ValueError(f"{name}: freqs_off on {freqs_off.device}, fields "
                         f"on {dev}")
    if freqs_off.dim() != 1:
        raise ValueError(f"{name}: freqs_off must be 1-D, got shape "
                         f"{tuple(freqs_off.shape)}")
    _check_cuda(name, (freqs_off,), freqs_off.shape)
    return freqs_off.shape[0]


def rrl_lanes_log2(n_chan: int) -> int:
    """log2 of the lanes per cell slot of the RRL maps kernels: a block
    takes RRL_CPL * lanes channels, lanes the power of two that covers
    n_chan / RRL_CPL, at most RRL_MAX_GROUP / RRL_CPL.  A warp's lanes
    split into 32 / lanes slots that share a column's cells."""
    lanes = 1
    while lanes * RRL_CPL < min(n_chan, RRL_MAX_GROUP):
        lanes *= 2
    return lanes.bit_length() - 1


def _rrl_grid_lanes(name: str, n_rows: int, n_chan: int) -> int:
    """``rrl_lanes_log2(n_chan)`` for a maps launch over ``n_rows`` row
    blocks, after checking that its one-dimensional grid fits."""
    lanes_log2 = rrl_lanes_log2(n_chan)
    group = RRL_CPL << lanes_log2
    if n_rows * -(-n_chan // group) > _MAX_GRID_X:
        raise ValueError(f"{name}: {n_rows} rows x {n_chan} channels "
                         f"exceed the launch grid")
    return lanes_log2


def _check_index(name: str, t, n: int, dev) -> None:
    if t.device != dev or t.dtype != torch.int32 or \
            tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({n},) int32 "
                         f"tensor on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def rrl_tiles(freqs_off, amp_t, rest_t, scale_t, yv_t, hkt_t, nu0: float,
              order, seg_start, nx: int, nz: int) -> torch.Tensor:
    """(n_chan, nx, nz) RRL optical-depth maps
    sum_y amp * Re w * (1 - e^{-(f + nu0) hkT}) from compacted
    (n_act, 8, 64, 128) float32 factor tiles (counterpart of
    pallas_kernels.rrl_tiles_pallas folded by segment_tile_maps): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.

    ``freqs_off`` and ``rest_t`` are offsets from the line centre ``nu0``
    [Hz]; ``(order, seg_start)`` are :func:`segment_order`'s, as int32
    tensors on the tiles' device (``seg_start`` of n_xt * n_zt + 1
    entries).  Every map element is written by the kernel, 0 where no tile
    lies on the line of sight."""
    name = 'rrl_tiles_pallas'
    if _device_kind(amp_t, name) == 'cpu':
        return rrl_tiles_plain(freqs_off, amp_t, rest_t, scale_t, yv_t,
                               hkt_t, nu0, order, seg_start, nx, nz)
    n_act = amp_t.shape[0]
    dev = amp_t.device
    _check_cuda(name, (amp_t, rest_t, scale_t, yv_t, hkt_t),
                (n_act,) + TILE)
    n_chan = _check_freqs(name, freqs_off, dev)
    n_xt, n_zt = _tile_grid(nx, TILE[0]), _tile_grid(nz, TILE[2])
    _check_index(name, order, n_act, dev)
    _check_index(name, seg_start, n_xt * n_zt + 1, dev)
    lanes_log2 = _rrl_grid_lanes(name, n_xt * n_zt * TILE[0], n_chan)
    out = torch.empty((n_chan, nx, nz), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().rrl_tiles(
            freqs_off.data_ptr(), amp_t.data_ptr(), rest_t.data_ptr(),
            scale_t.data_ptr(), yv_t.data_ptr(), hkt_t.data_ptr(),
            order.data_ptr(), seg_start.data_ptr(), out.data_ptr(), n_xt,
            n_zt, nx, nz, n_chan, lanes_log2, float(nu0), _weideman_struct(),
            _stream(dev))
    _raise_if_error(name, err)
    LAUNCHES[name] += 1
    return out


def rrl_tile_partials(freqs_off, amp_t, rest_t, scale_t, yv_t, hkt_t,
                      nu0: float) -> torch.Tensor:
    """(n_act, n_chan, 8, 128) per-tile RRL optical-depth partials of
    compacted factor tiles, the layout of pallas_kernels.rrl_tiles_pallas:
    for CUDA tensors the :func:`rrl_tiles` kernel with every tile its own
    segment (a column of n_act x tiles), for CPU tensors the plain
    version."""
    if _device_kind(amp_t, 'rrl_tiles_pallas') == 'cpu':
        return rrl_tile_partials_plain(freqs_off, amp_t, rest_t, scale_t,
                                       yv_t, hkt_t, nu0)
    n_act = amp_t.shape[0]
    ident = torch.arange(n_act + 1, dtype=torch.int32, device=amp_t.device)
    maps = rrl_tiles(freqs_off, amp_t, rest_t, scale_t, yv_t, hkt_t, nu0,
                     ident[:-1], ident, n_act * TILE[0], TILE[2])
    return maps.reshape(freqs_off.shape[0], n_act, TILE[0], TILE[2]) \
        .transpose(0, 1).contiguous()


def rrl_row_activity(amp: torch.Tensor) -> torch.Tensor:
    """(nx, ceil(ny / 64), ceil(nz / 128)) bool: which (1, 64, 128) row
    blocks of the full (nx, ny, nz) grid hold a cell with amp != 0 — the
    first pass of :func:`rrl_cube`, the one read of the whole amp cube.
    The CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    name = 'rrl_cube_pallas'
    if _device_kind(amp, name) == 'cpu':
        return rrl_row_activity_plain(amp)
    if amp.dim() != 3:
        raise ValueError(f"{name}: expected an (nx, ny, nz) cube, got "
                         f"shape {tuple(amp.shape)}")
    nx, ny, nz = amp.shape
    _check_cuda(name, (amp,), (nx, ny, nz))
    shape = (nx, _tile_grid(ny, RRL_ROW[1]), _tile_grid(nz, RRL_ROW[2]))
    if int(np.prod(shape)) > _MAX_GRID_X:
        raise ValueError(f"{name}: {shape} row blocks exceed the launch "
                         f"grid")
    active = torch.empty(shape, dtype=torch.uint8, device=amp.device)
    if active.numel() == 0:
        return active.view(torch.bool)
    with torch.cuda.device(amp.device):
        err = _lib().rrl_activity(amp.data_ptr(), active.data_ptr(), nx, ny,
                                  nz, _stream(amp.device))
    _raise_if_error(name, err)
    return active.view(torch.bool)


def rrl_cube(freqs_off, amp, rest, scale, yv, hkt,
             nu0: float) -> torch.Tensor:
    """(n_chan, nx, nz) RRL optical-depth maps of the FULL (nx, ny, nz)
    float32 factor grid (counterpart of pallas_kernels.rrl_cube_pallas):
    the model's branch when the grid holds no jet cell, so no tile is
    active.  The CUDA kernels for CUDA tensors (:func:`rrl_row_activity`,
    then the maps over the flagged row blocks), the plain version for CPU
    tensors."""
    name = 'rrl_cube_pallas'
    if _device_kind(amp, name) == 'cpu':
        return rrl_cube_plain(freqs_off, amp, rest, scale, yv, hkt, nu0)
    if amp.dim() != 3:
        raise ValueError(f"{name}: expected an (nx, ny, nz) cube, got "
                         f"shape {tuple(amp.shape)}")
    nx, ny, nz = amp.shape
    _check_cuda(name, (amp, rest, scale, yv, hkt), (nx, ny, nz))
    n_chan = _check_freqs(name, freqs_off, amp.device)
    lanes_log2 = _rrl_grid_lanes(name, nx * _tile_grid(nz, RRL_ROW[2]),
                                    n_chan)
    out = torch.empty((n_chan, nx, nz), dtype=torch.float32,
                      device=amp.device)
    if out.numel() == 0:
        return out
    active = rrl_row_activity(amp)
    with torch.cuda.device(amp.device):
        err = _lib().rrl_cube(
            freqs_off.data_ptr(), amp.data_ptr(), rest.data_ptr(),
            scale.data_ptr(), yv.data_ptr(), hkt.data_ptr(),
            active.data_ptr(), out.data_ptr(), nx, ny, nz, n_chan,
            lanes_log2, float(nu0), _weideman_struct(), _stream(amp.device))
    _raise_if_error(name, err)
    LAUNCHES[name] += 1
    return out


def transfer_scan_maps(source, dtau, observer_near_y0: bool = False):
    """Emergent intensity and total optical depth maps ``(I, tau_total)``,
    both (nx, nz), from (nx, ny, nz) source-function and per-cell opacity
    cubes: the ordered scan I = sum_y S e^{-tau_acc} (1 - e^{-dtau})
    (counterpart of pallas_kernels.transfer_scan_pallas).
    ``observer_near_y0`` selects which end of y faces the observer
    (radtrans.transfer_scan convention).  The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    name = 'transfer_scan_pallas'
    if _device_kind(source, name) == 'cpu':
        return transfer_scan_maps_plain(source, dtau, observer_near_y0)
    if source.dim() != 3:
        raise ValueError(f"{name}: expected an (nx, ny, nz) cube, got "
                         f"shape {tuple(source.shape)}")
    nx, ny, nz = source.shape
    _check_cuda(name, (source, dtau), (nx, ny, nz))
    if -(-nx // 8) > _MAX_GRID_YZ:      # eight x rows per block
        raise ValueError(f"{name}: nx = {nx} exceeds the launch grid")
    out_i = torch.empty((nx, nz), dtype=torch.float32, device=source.device)
    out_tau = torch.empty_like(out_i)
    if out_i.numel() == 0:
        return out_i, out_tau
    with torch.cuda.device(source.device):
        err = _lib().transfer_scan(
            source.data_ptr(), dtau.data_ptr(), out_i.data_ptr(),
            out_tau.data_ptr(), nx, ny, nz, int(bool(observer_near_y0)),
            _stream(source.device))
    _raise_if_error(name, err)
    LAUNCHES[name] += 1
    return out_i, out_tau


def _check_channels(name: str, consts, dev, cpt: int) -> int:
    """(n_chan,) float32 channel constants on the fields' device; ``cpt``
    channels go to one step of the launch grid's channel axis."""
    if consts[0].dim() != 1 or consts[0].device != dev:
        raise ValueError(f"{name}: channel constants must be 1-D on {dev}")
    n_chan = consts[0].shape[0]
    _check_cuda(name, consts, (n_chan,))
    if -(-n_chan // cpt) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: at most {_MAX_GRID_YZ * cpt} channels, "
                         f"got {n_chan}")
    return n_chan


def emergent_ff_full(cnu, hnuk, tau_scale, temp, dtau_base,
                     observer_near_y0: bool = False):
    """Multi-channel emergent free-free intensity and total optical depth,
    (n_chan, nx, nz) each, over the FULL (nx, ny, nz) grid (counterpart of
    pallas_kernels.emergent_ff_pallas): dtau = tau_scale[c] * dtau_base and
    S = cnu[c] / expm1(hnuk[c] / temp) per cell and channel, so no
    per-channel cube exists.  The model's branch when the grid holds no jet
    cell, so no tile is active.  The kernel reads ``dtau_base`` once per
    ``EMERGENT_GROUP_FULL`` channels and ``temp`` only where dtau_base != 0;
    it takes any grid shape and any contiguous view, 16-byte aligned or
    not.

    Args:
      cnu:       (n_chan,) blackbody prefactor 2 h nu^3 / c^2 [cgs]
      hnuk:      (n_chan,) h nu / k_B [K]
      tau_scale: (n_chan,) per-channel opacity multiplier
      temp:      (nx, ny, nz) temperature, safe (> 0) outside the jet
      dtau_base: (nx, ny, nz) frequency-independent opacity, 0 outside
    """
    name = 'emergent_ff_pallas'
    if _device_kind(temp, name) == 'cpu':
        return emergent_ff_full_plain(cnu, hnuk, tau_scale, temp, dtau_base,
                                      observer_near_y0)
    if temp.dim() != 3:
        raise ValueError(f"{name}: expected an (nx, ny, nz) cube, got "
                         f"shape {tuple(temp.shape)}")
    nx, ny, nz = temp.shape
    _check_cuda(name, (temp, dtau_base), (nx, ny, nz))
    n_chan = _check_channels(name, (cnu, hnuk, tau_scale), temp.device,
                             EMERGENT_GROUP_FULL)
    if nx * _tile_grid(nz, STRIP_W) > _MAX_GRID_X:
        raise ValueError(f"{name}: {nx} x {nz} columns exceed the launch "
                         f"grid")
    out_i = torch.empty((n_chan, nx, nz), dtype=torch.float32,
                        device=temp.device)
    out_tau = torch.empty_like(out_i)
    if out_i.numel() == 0:
        return out_i, out_tau
    with torch.cuda.device(temp.device):
        err = _lib().emergent_full(
            cnu.data_ptr(), hnuk.data_ptr(), tau_scale.data_ptr(),
            temp.data_ptr(), dtau_base.data_ptr(), out_i.data_ptr(),
            out_tau.data_ptr(), nx, ny, nz, n_chan,
            int(bool(observer_near_y0)), _stream(temp.device))
    _raise_if_error(name, err)
    LAUNCHES[name] += 1
    return out_i, out_tau


def emergent_tile_groups_log2(n_chan: int) -> int:
    """log2 of the channel groups G of a block of the emergent tile kernel:
    the power of two that covers n_chan / EMERGENT_CPT_TILES, at most
    EMERGENT_TILE_WARPS.  The block's warps are G channel groups times
    EMERGENT_TILE_WARPS / G chunks of a tile's 64 y cells."""
    groups = 1
    while groups * EMERGENT_CPT_TILES < n_chan and \
            groups < EMERGENT_TILE_WARPS:
        groups *= 2
    return groups.bit_length() - 1


def emergent_tile_partials(cnu, hnuk, tau_scale, temp_t, a_t, tss_t,
                           seg_start, t: float, bursts: Sequence,
                           pack_offset: float = 1.0):
    """Per-segment emergent intensity and total optical depth maps
    (n_seg, n_chan, 8, 128) from compacted observer-ordered
    (n_act, 8, 64, 128) tiles (counterpart of
    pallas_kernels.emergent_ff_tiles): dtau = a * chi(t - ts)^2 *
    tau_scale[c] with the burst factor evaluated per cell, tau carried
    across a segment's tiles.  Tiles come from
    :func:`active_tiles_scan_order` (temp gathered with fill 1.0, tss with
    fill 1.0); ``seg_start`` is the (n_seg + 1,) int32 tensor of
    :func:`segment_starts`.  The CUDA kernel for CUDA tensors (the
    (8, 64, 128) tile only), the plain version for CPU tensors (any tile
    shape)."""
    name = 'emergent_ff_tiles'
    if _device_kind(a_t, name) == 'cpu':
        return emergent_tile_partials_plain(cnu, hnuk, tau_scale, temp_t,
                                            a_t, tss_t, seg_start, t, bursts,
                                            pack_offset)
    n_act = a_t.shape[0]
    _check_cuda(name, (temp_t, a_t, tss_t), (n_act,) + TILE)
    groups_log2 = emergent_tile_groups_log2(cnu.numel())
    n_chan = _check_channels(name, (cnu, hnuk, tau_scale), a_t.device,
                             EMERGENT_CPT_TILES << groups_log2)
    if seg_start.device != a_t.device or seg_start.dtype != torch.int32 \
            or seg_start.dim() != 1 or seg_start.numel() < 1 \
            or not seg_start.is_contiguous():
        raise ValueError(f"{name}: seg_start must be a contiguous 1-D int32 "
                         f"tensor on {a_t.device}")
    n_seg = seg_start.numel() - 1
    if n_seg * TILE[0] * (TILE[2] // STRIP_W) > _MAX_GRID_X:
        raise ValueError(f"{name}: {n_seg} segments exceed the launch grid")
    b = _bursts_struct(bursts)
    out_i = torch.empty((n_seg, n_chan, TILE[0], TILE[2]),
                        dtype=torch.float32, device=a_t.device)
    out_tau = torch.empty_like(out_i)
    if out_i.numel() == 0:
        return out_i, out_tau
    with torch.cuda.device(a_t.device):
        err = _lib().emergent_tiles(
            cnu.data_ptr(), hnuk.data_ptr(), tau_scale.data_ptr(),
            temp_t.data_ptr(), a_t.data_ptr(), tss_t.data_ptr(),
            seg_start.data_ptr(), out_i.data_ptr(), out_tau.data_ptr(),
            n_seg, n_chan, groups_log2, float(t), float(pack_offset), b,
            _stream(a_t.device))
    _raise_if_error(name, err)
    LAUNCHES[name] += 1
    return out_i, out_tau


def emergent_ff_tiles(cnu, hnuk, tau_scale, temp_t, a_t, tss_t, seg_start,
                      it, kt, t: float, bursts: Sequence, nx: int, nz: int,
                      pack_offset: float = 1.0):
    """(n_chan, nx, nz) emergent intensity and total optical depth maps
    from compacted observer-ordered tiles: :func:`emergent_tile_partials`
    placed on the image by :func:`scatter_tile_maps` (``it``/``kt``: each
    segment's (x, z) tile coordinates)."""
    inten, tau = emergent_tile_partials(cnu, hnuk, tau_scale, temp_t, a_t,
                                        tss_t, seg_start, t, bursts,
                                        pack_offset)
    bx, bz = a_t.shape[1], a_t.shape[3]
    n_xt, n_zt = _tile_grid(nx, bx), _tile_grid(nz, bz)
    return (scatter_tile_maps(inten, it, kt, n_xt, n_zt, nx, nz),
            scatter_tile_maps(tau, it, kt, n_xt, n_zt, nx, nz))


def wofz_kernel(x: torch.Tensor, y: torch.Tensor):
    """``(Re w, Im w)`` of w(x + iy), y >= 0, for CUDA tensors of one shape
    and dtype (float64 or float32) by the kernel of csrc/voigt.cu: the
    scheme of ``ops/voigt._wofz_core`` and ``_wofz_eval`` (their plain
    version) in one launch.  Views, expanded ones included, are made
    contiguous first; the outputs are new contiguous tensors."""
    name = 'wofz'
    if x.device.type != 'cuda' or y.device != x.device:
        raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                         f"device, got {x.device} and {y.device}")
    if x.dtype not in (torch.float64, torch.float32) or y.dtype != x.dtype:
        raise TypeError(f"{name}: the CUDA kernel takes float64 or float32, "
                        f"got {x.dtype} and {y.dtype}")
    if x.shape != y.shape:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)} differ")
    x, y = x.contiguous(), y.contiguous()
    re, im = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return re, im
    with torch.cuda.device(x.device):
        lib = _lib()
        launch = lib.wofz_f64 if x.dtype == torch.float64 else lib.wofz_f32
        err = launch(x.data_ptr(), y.data_ptr(), re.data_ptr(),
                     im.data_ptr(), x.numel(), _wofz_struct(x.dtype),
                     _stream(x.device))
    _raise_if_error(name, err)
    LAUNCHES[name] += 1
    return re, im


def rrl_flux_maps(freqs, scale, a_map, tbar, any_in, tau_l, csize_au,
                  dist_pc, contsub: bool) -> torch.Tensor:
    """(n_chan, nx, nz) LTE RRL flux maps [Jy/pixel]: the line, plus the
    free-free continuum unless ``contsub``, from the channels ``freqs`` and
    their continuum opacity scale ``scale`` (n_chan,), the 2-D continuum
    base map ``a_map``, the LOS-mean temperature ``tbar`` and silhouette
    ``any_in`` (nx, nz), the line opacity maps ``tau_l``, the cell size
    [au] and the distance [pc].  CUDA float32 tensors go to the kernel of
    csrc/rrl_flux.cu, CPU tensors to the plain version
    ``radtrans.rrl_flux_maps_lte``; an input that requires grad raises (the
    kernel has no backward).  Counts ``rt.rrl_flux_stages`` on every call
    and ``rt.rrl_flux_kernel`` on each launch."""
    from . import radtrans as rt     # radtrans imports this module
    name = 'rrl_flux'
    if any(isinstance(x, torch.Tensor) and x.requires_grad for x in
           (freqs, scale, a_map, tbar, any_in, tau_l, csize_au, dist_pc)):
        raise ValueError(f"{name}: the kernel has no backward; an input "
                         f"requires grad")
    kind = _device_kind(tau_l, name)
    profiling.count('rt.rrl_flux_stages')
    if kind == 'cpu':
        return rt.rrl_flux_maps_lte(freqs, scale, a_map, tbar, any_in, tau_l,
                                    csize_au, dist_pc, contsub)
    if tau_l.dim() != 3:
        raise ValueError(f"{name}: tau_l must be (n_chan, nx, nz), got "
                         f"{tuple(tau_l.shape)}")
    n_chan, nx, nz = tau_l.shape
    dev = tau_l.device
    _check_cuda(name, (tau_l,), (n_chan, nx, nz))
    _check_cuda(name, (freqs, scale), (n_chan,))
    _check_cuda(name, (a_map, tbar), (nx, nz))
    if any(x.device != dev for x in (freqs, a_map, any_in)):
        raise ValueError(f"{name}: every tensor must be on {dev}")
    if any_in.dtype != torch.bool or tuple(any_in.shape) != (nx, nz) or \
            not any_in.is_contiguous():
        raise ValueError(f"{name}: any_in must be a contiguous bool "
                         f"({nx}, {nz}) tensor")
    npix = nx * nz
    if npix >= 2 ** 31 or n_chan > _MAX_GRID_YZ * RRL_FLUX_CB:
        raise ValueError(f"{name}: {n_chan} x {nx} x {nz} exceeds the "
                         f"launch grid")
    out = torch.empty_like(tau_l)
    if out.numel() == 0:
        return out
    vec = int(npix % 4 == 0 and tau_l.data_ptr() % 16 == 0 and
              out.data_ptr() % 16 == 0)
    k = _RrlFluxConsts(_BB_PREFACTOR_CBRT, cnsts.H_CGS, cnsts.K_CGS,
                       cnsts.K_B, cnsts.C ** 2,
                       float(rt.flux_scale_jy(csize_au, dist_pc)))
    with torch.cuda.device(dev):
        err = _lib().rrl_flux(freqs.data_ptr(), scale.data_ptr(),
                              a_map.data_ptr(), tbar.data_ptr(),
                              any_in.data_ptr(), tau_l.data_ptr(),
                              out.data_ptr(), n_chan, npix, vec,
                              int(bool(contsub)), k, _stream(dev))
    _raise_if_error(name, err)
    LAUNCHES[name] += 1
    profiling.count('rt.rrl_flux_kernel')
    return out


class HogbomCycle:
    """Hogbom's minor cycle on every channel of CUDA (b, n, n) ``dirty``
    and ``psf`` (one dtype, float64 or float32, any layout) by the
    kernels of csrc/hogbom.cu, the state on the card: :meth:`step` runs one
    iteration on every channel still above its threshold in two launches
    and returns the channels' flags (int32, 1 while a channel goes on);
    :meth:`finish` applies the last iteration's subtraction and returns
    (model, residual, per-channel iteration counts).  A channel at or
    below its threshold is finished: its launches return at once.  The
    plain version is ``synthobs/imaging._hogbom_plain``; the two give the
    same bits but for the sign of a residual's zeros (equal under
    ``torch.equal``).  ``mask`` (n, n) and ``thresholds`` (b,) are cast to
    the planes' dtype, as the plain version casts them."""

    def __init__(self, dirty: torch.Tensor, psf: torch.Tensor, mask,
                 thresholds, gain: float):
        name = 'hogbom'
        if dirty.device.type != 'cuda' or psf.device != dirty.device:
            raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                             f"device, got {dirty.device} and {psf.device}")
        if dirty.dtype not in (torch.float64, torch.float32) or \
                psf.dtype != dirty.dtype:
            raise TypeError(f"{name}: the CUDA kernel takes float64 or "
                            f"float32, got {dirty.dtype} and {psf.dtype}")
        if dirty.dim() != 3 or dirty.shape[1] != dirty.shape[2] or \
                psf.shape != dirty.shape:
            raise ValueError(f"{name}: expected (b, n, n) dirty and psf of "
                             f"one shape, got {tuple(dirty.shape)} and "
                             f"{tuple(psf.shape)}")
        nb, n, _ = dirty.shape
        if n * n >= 2 ** 31 or nb > _MAX_GRID_YZ:
            raise ValueError(f"{name}: {nb} x {n} x {n} exceeds the launch "
                             f"grid")
        dev, dt = dirty.device, dirty.dtype
        self.device, self.nb, self.n = dev, nb, n
        self.mask = torch.as_tensor(mask, dtype=dt, device=dev).reshape(
            n * n).contiguous()
        self.thr = torch.as_tensor(thresholds, dtype=dt, device=dev).reshape(
            nb).contiguous()
        self.psf, self.gain = psf.contiguous(), float(gain)
        self.res = dirty.reshape(nb, n * n).clone()
        self.model = torch.zeros_like(self.res)
        self.count = torch.zeros(nb, dtype=torch.int64, device=dev)
        self.live = torch.ones(nb, dtype=torch.int32, device=dev)
        self.peak = torch.zeros(nb, dtype=torch.int32, device=dev)
        self.val = torch.zeros(nb, dtype=dt, device=dev)
        n_tiles = -(-n * n // HOGBOM_TILE)
        self.part_v = torch.empty((nb, n_tiles), dtype=dt, device=dev)
        self.part_i = torch.empty((nb, n_tiles), dtype=torch.int32,
                                  device=dev)
        self.dbl = int(dt == torch.float64)
        self.steps = 0

    def _update_peak(self, lib, stream, find: bool) -> None:
        err = lib.hogbom_update_peak(
            self.res.data_ptr(), self.psf.data_ptr(), self.mask.data_ptr(),
            self.live.data_ptr(), self.peak.data_ptr(), self.val.data_ptr(),
            self.part_v.data_ptr(), self.part_i.data_ptr(), self.nb, self.n,
            self.dbl, int(self.steps > 0), int(find), stream)
        _raise_if_error('hogbom', err)
        LAUNCHES['hogbom'] += 1

    def step(self) -> torch.Tensor:
        """One iteration: the previous one's subtraction and this one's
        peaks, then the components.  Nothing waits for the card."""
        if self.nb and self.n:
            with torch.cuda.device(self.device):
                lib, stream = _lib(), _stream(self.device)
                self._update_peak(lib, stream, True)
                err = lib.hogbom_component(
                    self.res.data_ptr(), self.model.data_ptr(),
                    self.thr.data_ptr(), self.live.data_ptr(),
                    self.peak.data_ptr(), self.val.data_ptr(),
                    self.count.data_ptr(), self.part_v.data_ptr(),
                    self.part_i.data_ptr(), self.nb, self.n, self.dbl,
                    self.gain, stream)
                _raise_if_error('hogbom', err)
                LAUNCHES['hogbom'] += 1
        self.steps += 1
        return self.live

    def finish(self):
        """(model, residual, counts): (b, n, n), (b, n, n), int64 (b,)."""
        if self.steps and self.nb and self.n:
            with torch.cuda.device(self.device):
                self._update_peak(_lib(), _stream(self.device), False)
        shape = (self.nb, self.n, self.n)
        return self.model.view(shape), self.res.view(shape), self.count
