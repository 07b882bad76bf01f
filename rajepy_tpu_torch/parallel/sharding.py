"""Device-mesh sharding of the radiative transfer (PyTorch port of
rajepy_tpu.parallel.sharding).

The JAX package is single-controller: one Python process drives every
device.  So is this port, without ``torch.distributed``: a mesh is an
``(n_chan, n_los)`` array of ``torch.device``s (:class:`Mesh`), and this
process issues each shard's work to its device in turn.  CUDA launches are
asynchronous, so the devices overlap.

* **LOS** — the voxel grid is cut along the line of sight (y) into
  ``n_los`` slabs, one on each LOS shard's device (:class:`Sharded`).
  Every RT product is a masked sum along y, so a slab gives a partial
  map; the partial maps are moved to the first device of their mesh row
  and added in mesh order (the JAX ``psum``, here deterministic).
* **Channels** — channel blocks split over the ``'chan'`` axis with no
  communication.
* **Epochs and runs** — split over every device of the mesh
  (:func:`light_curve_sharded`, :mod:`.fanout`).

A mesh may name one device more than once (``[torch.device('cpu')] * 8``,
``[torch.device('cuda', 0)] * 4``): every sharded path then runs on that
one device, which is how the CPU tests and a one-card machine drive them.
Between devices the maps move by ``Tensor.to`` (peer copies between
cards).  The default device list is :func:`available_devices`.

Every function that takes grid cubes takes whole tensors or LOS-sharded
slab lists (:func:`shard_fields`, :func:`put`, :func:`sharded_static_fields`);
the maps split over ``'chan'`` come back as :class:`Sharded` (``gather()``
or ``numpy.asarray`` assembles them).  Where the JAX package needs ``ny``
to tile over ``'los'`` this module raises ``ValueError``; the channel, tile
and epoch axes split unevenly where they do not divide, and nothing is
padded.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import fields as mfields
from ..models import grid as mgrid
from ..ops import kernels as kn
from ..ops import radtrans as rt

LOS_AXIS = rt.LOS_AXIS


def _device(device) -> torch.device:
    """``device`` as a torch.device with its index (``'cuda'`` is the
    current card)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def available_devices(model_device) -> List[torch.device]:
    """The devices that a model's sharded paths spread over by default:
    every CUDA card for a model on a card, the one CPU for a CPU model.
    Tests and ``chip_smoke.py`` replace this function for a block, to put
    several shards on one device."""
    if torch.device(model_device).type == 'cuda':
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [torch.device('cpu')]


def _default_device() -> str:
    return 'cuda' if torch.cuda.is_available() else 'cpu'


class Mesh:
    """An array of ``torch.device``s with named axes, the shape of
    ``jax.sharding.Mesh``: ``devices`` (a numpy object array),
    ``axis_names`` and ``shape`` (``{axis name: extent}``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [_device(d) for d in np.asarray(devices, dtype=object).ravel()]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(np.shape(devices))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.ravel())})"


def make_mesh(n_los: Optional[int] = None, n_chan: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('chan', 'los') mesh.  By default the devices are
    :func:`available_devices`, all on the LOS axis."""
    devices = list(devices if devices is not None else
                   available_devices(_default_device()))
    if n_los is None:
        n_los = len(devices) // n_chan
    if n_chan * n_los > len(devices) or n_chan * n_los == 0:
        raise ValueError(f"a ({n_chan}, {n_los}) mesh needs "
                         f"{n_chan * n_los} devices, {len(devices)} given")
    arr = np.empty(n_chan * n_los, dtype=object)
    arr[:] = devices[:n_chan * n_los]
    return Mesh(arr.reshape(n_chan, n_los), ('chan', 'los'))


class Layout(NamedTuple):
    """Where an array's parts lie on a mesh: its axis ``dim`` split over
    the mesh axis ``axis``, part k on the first device of index k along
    that axis (the port's ``NamedSharding``)."""
    mesh: Mesh
    dim: int
    axis: str


def grid_sharding(mesh: Mesh) -> Layout:
    """Voxel grids (nx, ny, nz) cut along the LOS (y) axis."""
    return Layout(mesh, LOS_AXIS, 'los')


def chan_sharding(mesh: Mesh) -> Layout:
    """Per-channel arrays split along the channel axis."""
    return Layout(mesh, 0, 'chan')


def map_sharding(mesh: Mesh) -> Layout:
    """Collapsed (n_chan, nx, nz) maps: the channel axis split."""
    return Layout(mesh, 0, 'chan')


class Sharded(NamedTuple):
    """A tensor cut along ``dim`` into ``parts``, in mesh order, each on
    its shard's device."""
    parts: Tuple[torch.Tensor, ...]
    dim: int

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first part's)."""
        device = self.parts[0].device if device is None else device
        return torch.cat([p.to(device) for p in self.parts], dim=self.dim)

    def __array__(self, dtype=None, copy=None):
        a = self.gather().cpu().numpy()
        return a if dtype is None else a.astype(dtype)


def _axis_devices(mesh: Mesh, axis: str) -> list:
    """The first device of each index along ``axis``."""
    i = mesh.axis_names.index(axis)
    return list(np.moveaxis(mesh.devices, i, 0).reshape(
        mesh.devices.shape[i], -1)[:, 0])


def _split(x, layout: Layout) -> list:
    """The parts of ``x`` (a whole tensor or :class:`Sharded`) under
    ``layout``, each on its device.  The LOS axis must tile over 'los';
    other axes split unevenly where they do not divide."""
    devs = _axis_devices(layout.mesh, layout.axis)
    if not isinstance(x, (Sharded, torch.Tensor)):
        x = torch.as_tensor(np.asarray(x))
    if isinstance(x, Sharded):
        if x.dim != layout.dim or len(x.parts) != len(devs):
            raise ValueError(f"{len(x.parts)} parts along dim {x.dim}, the "
                             f"layout wants {len(devs)} along {layout.dim}")
        parts = x.parts
    else:
        if layout.axis == 'los' and x.shape[layout.dim] % len(devs):
            raise ValueError(
                f"the LOS axis ({x.shape[layout.dim]} cells) does not tile "
                f"over the mesh's {len(devs)} 'los' shards")
        parts = torch.tensor_split(x, len(devs), dim=layout.dim)
    return [p.to(d).contiguous() for p, d in zip(parts, devs)]


def put(x, layout: Layout) -> Sharded:
    """``x`` cut and placed by ``layout`` (the port's
    ``jax.device_put(x, sharding)``)."""
    return Sharded(tuple(_split(x, layout)), layout.dim)


def shard_fields(fields, mesh: Mesh):
    """Every grid of a StaticFields cut into LOS slabs, one on each LOS
    shard's device."""
    lay = grid_sharding(mesh)
    return type(fields)(*(put(a, lay) if a.dim() == 3 else a
                          for a in fields))


def _psum(parts, device) -> torch.Tensor:
    """The shards' partial maps moved to ``device`` and added in mesh
    order."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _fill_slab(static_params, rb_frac, nx, ny, nz, csize, dtype, with_time,
               lo, hi, device):
    """The grid fill of the y rows lo..hi-1 on ``device``: the fill is per
    cell, so these are the whole fill's rows bit for bit."""
    xx, yy, zz = mgrid.grid_corner_coords(nx, ny, nz, csize, dtype, device)
    return mfields.compute_static_fields(static_params, xx, yy[:, lo:hi], zz,
                                         rb_frac, with_time=with_time)


def _fill_setup(mesh, ny, dtype):
    devs = _axis_devices(mesh, 'los')
    if ny % len(devs):
        raise ValueError(f"ny = {ny} does not tile over the mesh's "
                         f"{len(devs)} 'los' shards")
    if dtype is None:
        dtype = torch.float32 if devs[0].type == 'cuda' else torch.float64
    step = ny // len(devs)
    return devs, dtype, step


def sharded_static_fields(mesh: Mesh, static_params, rb_frac: float,
                          nx: int, ny: int, nz: int, csize: float,
                          dtype=None, with_time: bool = True):
    """The grid fill built LOS-sharded: each LOS shard fills its own y slab
    on its device, so no device ever holds the whole cube set.  Returns a
    StaticFields of :class:`Sharded` slabs, equal to the single-device
    fill's rows bit for bit (the fill is per-cell pure), which feed
    :func:`sharded_rt_products` and :func:`sharded_rrl_tau_maps`.

    ``static_params``/``rb_frac`` as JetModel passes them
    (``JetModel._static_params()`` / ``_ss_jml_rb_frac``); ``ny`` must tile
    over the mesh's 'los' axis; ``dtype`` defaults to float32 on a card,
    float64 on the CPU."""
    devs, dtype, step = _fill_setup(mesh, ny, dtype)
    slabs = [_fill_slab(static_params, rb_frac, nx, ny, nz, csize, dtype,
                        with_time, k * step, (k + 1) * step, d)
             for k, d in enumerate(devs)]
    return mfields.StaticFields(*(Sharded(tuple(parts), LOS_AXIS)
                                  for parts in zip(*slabs)))


def fill_memory_stats(mesh: Mesh, static_params, rb_frac: float,
                      nx: int, ny: int, nz: int, csize: float,
                      dtype=None, with_time: bool = True):
    """Per-device bytes of the LOS-sharded grid fill, the keys of the JAX
    package's: ``per_device_bytes`` is, on a card, the measured peak of the
    largest shard's fill above what was resident
    (``torch.cuda.max_memory_allocated`` after a reset), and ``None`` on
    the CPU, which reports nothing; ``per_device_output_bytes``,
    ``full_output_bytes`` and ``min_leaf_bytes`` come from the shapes."""
    devs, dtype, step = _fill_setup(mesh, ny, dtype)
    float_bytes = torch.tensor([], dtype=dtype).element_size()
    leaf_bytes = [nx * ny * nz * (1 if name in ('inside', 'red') else
                                  float_bytes)
                  for name in mfields.StaticFields._fields]
    per_dev = None
    if devs[0].type == 'cuda':
        dev = devs[0]
        torch.cuda.synchronize(dev)
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        slab = _fill_slab(static_params, rb_frac, nx, ny, nz, csize, dtype,
                          with_time, 0, step, dev)
        torch.cuda.synchronize(dev)
        per_dev = torch.cuda.max_memory_allocated(dev) - resident
        del slab
    return {'per_device_bytes': per_dev,
            'per_device_output_bytes': sum(leaf_bytes) // len(devs),
            'full_output_bytes': sum(leaf_bytes),
            'min_leaf_bytes': min(leaf_bytes),
            'n_los': len(devs)}


def _los_slabs(mesh: Mesh, *cubes) -> list:
    """Per LOS shard, its slab of each cube, on that shard's device."""
    lay = grid_sharding(mesh)
    return list(zip(*(_split(c, lay) for c in cubes)))


def _channel_stage(mesh: Mesh, freqs, fn) -> Sharded:
    """``fn(freqs_block, device)`` on each 'chan' shard's block of
    ``freqs``, as a channel-split :class:`Sharded`."""
    blocks = _split(freqs, chan_sharding(mesh))
    devs = _axis_devices(mesh, 'chan')
    return Sharded(tuple(fn(fr, d) for fr, d in zip(blocks, devs)), 0)


def sharded_continuum_step(mesh: Mesh, t_0: float, reynolds_gaunt: bool):
    """The multi-device free-free opacity step: ``fn(freqs, temp, n_es,
    ds_cm, inside)`` -> (n_chan, nx, nz) tau maps, channel-split.  Each LOS
    slab sums its masked base opacity, the partial maps are summed over
    'los', and each 'chan' shard scales the map for its channels."""

    def step(freqs, temp, n_es, ds_cm, inside):
        root = mesh.devices[0, 0]
        base = _psum([torch.sum(rt.tau_ff_base(t, n, d, i, reynolds_gaunt),
                                dim=LOS_AXIS)
                      for t, n, d, i in _los_slabs(mesh, temp, n_es, ds_cm,
                                                   inside)], root)
        return _channel_stage(mesh, freqs, lambda fr, dev: (
            rt.tau_ff_channel_scale(fr, t_0, reynolds_gaunt)[:, None, None]
            * base.to(dev)[None]))

    return step


def sharded_rt_products(mesh: Mesh, t_0: float, reynolds_gaunt: bool,
                        csize_au: float, dist_pc):
    """The full sharded continuum RT step: ``fn(freqs, nd, xi, temp, ff,
    area, inside)`` -> (EM map, tau maps, flux maps).  Each LOS slab gives
    its partial EM and base-opacity maps and the numerator and count of
    its LOS-mean temperature (a mean of the slabs' means would be wrong);
    these are summed over 'los' on the mesh's first device, which keeps the
    EM map, and the channel stage runs per 'chan' shard (channel-split
    maps)."""

    def step(freqs, nd, xi, temp, ff, area, inside):
        root = mesh.devices[0, 0]
        em, base, s, n = [], [], [], []
        for nd_, xi_, t_, ff_, ar_, in_ in _los_slabs(mesh, nd, xi, temp,
                                                      ff, area, inside):
            ds = rt.path_length_cm(ff_, ar_, csize_au)
            em.append(rt.emission_measure_map(nd_, xi_, ff_, ar_, csize_au))
            base.append(torch.sum(rt.tau_ff_base(t_, nd_ * xi_, ds, in_,
                                                 reynolds_gaunt),
                                  dim=LOS_AXIS))
            s_, n_ = rt.temperature_sums(t_, in_)
            s.append(s_)
            n.append(n_)
        em, base = _psum(em, root), _psum(base, root)
        tbar, any_in = rt.mean_temperature_from_sums(_psum(s, root),
                                                     _psum(n, root))

        def channels(fr, dev):
            taus = rt.tau_ff_channel_scale(fr, t_0, reynolds_gaunt)[
                :, None, None] * base.to(dev)[None]
            return taus, rt.flux_ff_maps(fr, taus, tbar.to(dev),
                                         any_in.to(dev), csize_au, dist_pc)

        out = _channel_stage(mesh, freqs, channels)
        return (em, Sharded(tuple(p[0] for p in out.parts), 0),
                Sharded(tuple(p[1] for p in out.parts), 0))

    return step


def _rrl_partial(coeffs, freqs, temp, n_es, vy, ds_cm, inside):
    """One shard's line-opacity maps of its channels on its slab: the RRL
    cube kernel (K5) on a float32 card slab, the plain loop elsewhere."""
    if freqs.numel() == 0:
        return temp.new_zeros((0, temp.shape[0], temp.shape[2]))
    if temp.is_cuda and temp.dtype == torch.float32:
        return rt.tau_rrl_maps_fused(coeffs, freqs, temp, n_es, vy, ds_cm,
                                     inside)
    return rt.tau_rrl_maps(coeffs, freqs, temp, n_es, vy, ds_cm, inside)


def sharded_rrl_tau_maps(mesh: Mesh, coeffs, freqs, temp, n_es, vy, ds_cm,
                         inside) -> Sharded:
    """Collapsed RRL optical-depth maps on a ('chan', 'los') mesh, sharded
    both ways: shard (c, l) computes the channel block c on the y slab l
    (through K5 on a float32 card slab, the plain per-channel loop on the
    CPU), and the partial maps are summed over 'los' on the first device
    of row c.  Returns the (n_chan, nx, nz) maps, channel-split."""
    slabs = _los_slabs(mesh, temp, n_es, vy, ds_cm, inside)
    blocks = _split(freqs, chan_sharding(mesh))
    out = []
    for c, fr in enumerate(blocks):
        parts = []
        for slab, dev in zip(slabs, mesh.devices[c]):
            parts.append(_rrl_partial(coeffs, fr.to(dev),
                                      *(x.to(dev) for x in slab)))
        out.append(_psum(parts, mesh.devices[c, 0]))
    return Sharded(tuple(out), 0)


def sharded_transfer_scan(mesh: Mesh, source, dtau,
                          observer_near_y0: bool = False):
    """Ordered LOS transfer integral sharded along the LOS axis.

    Shard (c, l) runs the ordered scan (K8 on a float32 card slab, its
    plain version on the CPU: ``kernels.transfer_scan_maps``) over the x
    block c of the y slab l, giving the slab's emergent intensity I_s and
    total opacity tau_s; the slabs compose through the (attenuation,
    accumulated-intensity) monoid

        I = sum_s I_s * exp(-sum_{t in front of s} tau_t),

    "in front" being the slabs of smaller index when ``observer_near_y0``,
    else of larger index.  (The JAX package repeats the scan on every
    'chan' shard; the columns are independent, so here 'chan' splits x.)
    Returns ``(intensity, tau_total)``, both (nx, nz), on the mesh's first
    device; equal to the whole cube's scan up to the order of the sums."""
    slabs = _los_slabs(mesh, source, dtau)
    n_chan = mesh.shape['chan']
    i_blocks, tau_blocks = [], []
    for c in range(n_chan):
        scans = []
        for (src, dt), dev in zip(slabs, mesh.devices[c]):
            src, dt = (torch.tensor_split(x, n_chan, dim=0)[c].to(dev)
                       .contiguous() for x in (src, dt))
            scans.append(kn.transfer_scan_maps(src, dt, observer_near_y0))
        i_c, tau_c = _compose_scans(scans, mesh.devices[c, 0],
                                    observer_near_y0)
        i_blocks.append(i_c)
        tau_blocks.append(tau_c)
    root = mesh.devices[0, 0]
    return (torch.cat([b.to(root) for b in i_blocks]),
            torch.cat([b.to(root) for b in tau_blocks]))


def _compose_scans(scans, device, observer_near_y0: bool):
    """The monoid composition of the slabs' ``(I_s, tau_s)`` on
    ``device``."""
    taus = [t.to(device) for _, t in scans]
    total = None
    for s, (i_s, _) in enumerate(scans):
        front = taus[:s] if observer_near_y0 else taus[s + 1:]
        tau_front = torch.zeros_like(taus[s])
        for t in front:
            tau_front = tau_front + t
        term = i_s.to(device) * torch.exp(-tau_front)
        total = term if total is None else total + term
    return total, _psum(taus, device)


def _row_blocks(seg_start: np.ndarray, n_zt: int, n_shards: int):
    """Contiguous blocks of x-tile rows, one per shard, holding about equal
    numbers of tiles: ``[(i0, i1), ...]`` (empty blocks dropped)."""
    n_xt = (len(seg_start) - 1) // n_zt
    cum = seg_start[::n_zt].astype(np.int64)       # tiles before row i
    cuts = np.searchsorted(cum, cum[-1] * np.arange(1, n_shards) / n_shards)
    bounds = np.concatenate([[0], np.clip(cuts, 0, n_xt), [n_xt]])
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])
            if b > a]


def sharded_epoch_base_map_tiles(mesh: Mesh, base_t, tss_t, seg, t,
                                 bursts, nx: int, nz: int,
                                 pack_offset: float = 1.0, walk=None):
    """The LOS-collapsed sum_y base * chi(t - ts)^2 over COMPACTED
    jet-occupied tiles, with the tile positions split over every device
    of the mesh: each shard takes a block of x-tile rows (about equal
    numbers of tiles), runs ``kernels.epoch_base_map_tiles`` (K1 on card
    tiles, its plain version on the CPU) on those rows' tiles on its
    device, and the disjoint row blocks are stacked on the mesh's first
    device.  Each position's tiles are walked in the single-device order,
    so the map is the single-device map bit for bit.

    Arguments are ``kernels.epoch_base_map_tiles``' (the burst list and
    the walk of ``kernels.segment_order``; the JAX package takes its
    ejection specs instead)."""
    devs = list(mesh.devices.ravel())
    bx, bz = kn.TILE[0], kn.TILE[2]
    n_zt = -(-nz // bz)
    n_seg = -(-nx // bx) * n_zt
    seg = kn._index(seg, base_t.device)
    if walk is None:
        order, seg_start = kn.segment_order(seg.cpu().numpy(), n_seg)
    else:
        order, seg_start = (w.cpu().numpy() for w in walk)
    blocks = []
    for dev, (i0, i1) in zip(devs, _row_blocks(seg_start, n_zt, len(devs))):
        lo, hi = int(seg_start[i0 * n_zt]), int(seg_start[i1 * n_zt])
        idx = torch.as_tensor(order[lo:hi], dtype=torch.int64,
                              device=base_t.device)
        sub_walk = (torch.arange(hi - lo, dtype=torch.int32, device=dev),
                    torch.as_tensor(seg_start[i0 * n_zt:i1 * n_zt + 1] - lo,
                                    dtype=torch.int32, device=dev))
        blocks.append(kn.epoch_base_map_tiles(
            base_t[idx].to(dev), tss_t[idx].to(dev),
            (seg[idx] - i0 * n_zt).to(dev), t, bursts,
            min(i1 * bx, nx) - i0 * bx, nz, pack_offset, walk=sub_walk))
    return torch.cat([b.to(devs[0]) for b in blocks])


def light_curve_sharded(model, times_yr, freqs,
                        mesh: Optional[Mesh] = None) -> np.ndarray:
    """Multi-epoch light curve with the epochs split over the devices of
    ``mesh`` (default :func:`available_devices`): each shard runs the
    per-epoch body of ``models.analysis.light_curve`` (K1 once per epoch
    on a float32 model with bursts, the channel stage and the sum) on the
    model's statics on its device (``JetModel._replica``).  Returns
    (n_times, n_chan) integrated fluxes [Jy], equal to ``light_curve``
    bit for bit where the shards share the model's device."""
    from ..models import analysis
    devs = list(mesh.devices.ravel()) if mesh is not None else \
        available_devices(model.device)
    times = np.atleast_1d(np.asarray(times_yr, dtype=float))
    sums = [analysis.epoch_flux_sums(model._replica(d), ts, freqs)
            for d, ts in zip(devs, np.array_split(times, len(devs)))
            if ts.size]
    return np.concatenate([s.cpu().numpy() for s in sums])


def sharded_clean_cube(mesh: Mesh, uvw_m, freqs, vis, weights, n_pix: int,
                       cell_rad: float, mask, beam_kernel, **clean_kwargs):
    """Cube imaging with the channels split over the mesh's 'chan' axis:
    each shard runs ``synthobs.imaging.clean_cube`` on its block of
    channels on its device, with no communication.  No bit of
    ``clean_cube`` depends on the channel block, so the cube is the
    unsharded one bit for bit.

    Arguments are ``clean_cube``'s (complex ``vis`` (n_chan, n_vis); the
    JAX package takes its real and imaginary parts); an ``info`` dict
    receives the shards' counts (blocks and iterations summed, the block
    size and the most iterations the largest).  Returns (restored, dirty),
    each a channel-split :class:`Sharded` of (n_chan, n_pix, n_pix)."""
    from ..synthobs import imaging
    info = clean_kwargs.pop('info', None)
    freqs = np.asarray(freqs, dtype=float)
    devs = _axis_devices(mesh, 'chan')
    restored, dirty, infos = [], [], []
    for dev, idx in zip(devs, np.array_split(np.arange(len(freqs)),
                                             len(devs))):
        if not idx.size:
            continue
        part = {}
        r, d = imaging.clean_cube(uvw_m, freqs[idx], vis[idx[0]:idx[-1] + 1]
                                  .to(dev), weights, n_pix, cell_rad, mask,
                                  beam_kernel, info=part, **clean_kwargs)
        restored.append(r)
        dirty.append(d)
        infos.append(part)
    if info is not None:
        info.update(
            chan_block=max(i['chan_block'] for i in infos),
            n_blocks=sum(i['n_blocks'] for i in infos),
            iterations=max(i['iterations'] for i in infos),
            loop_iterations=sum(i['loop_iterations'] for i in infos),
            channel_iterations=sum(i['channel_iterations'] for i in infos))
    return Sharded(tuple(restored), 0), Sharded(tuple(dirty), 0)
