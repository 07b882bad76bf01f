"""JetModel — the physical jet model and its continuum and radio-
recombination-line radiative-transfer products (PyTorch port of the
continuum and RRL surface of rajepy_tpu.models.jetmodel).

* the params dict (same schema as data/example-model-params.py,
  ``n_0`` derived) defines a static model; its grids are filled once by
  :func:`.fields.compute_static_fields` on the model's ``device``;
* ejection bursts are data (:mod:`.ejection`), so the burst factor is one
  elementwise pass and models pickle cleanly;
* the continuum opacity factorises in frequency, so one LOS reduction per
  epoch serves every channel (:mod:`..ops.radtrans`).

Device and precision: ``device`` defaults to ``'cuda'`` and raises when no
card is present; CPU use is explicit (``device='cpu'``).  ``dtype='auto'``
is float32 on CUDA and float64 on the CPU; ``'parity'`` is float64.

The per-epoch maps: a float32 model with bursts streams the jet-occupied
(8, 64, 128) tiles of its epoch-independent cubes through the epoch kernels
of :mod:`..ops.kernels` (on CUDA tensors the hand-written kernels, on CPU
tensors their plain versions); a float64 model, or one without bursts,
takes the plain sum over y.

The RRL line opacity: a float32 model evaluates the channel-independent
opacity factors on the jet-occupied tiles and streams them through the RRL
tile kernel (or, when no tile is active, the full grid through the RRL
cube kernel), with or without bursts; a float64 model takes the plain
per-channel loop.  Non-LTE products take departure coefficients from the
bundled case-B table (:mod:`..ops.departure`) or from the caller.

The ordered emergent intensity (``emergent_intensity_ff``): a float32
model streams its jet-occupied tiles, flipped into observer order, through
the emergent tile kernel (or, when no tile is active, the full grid through
the emergent full-grid kernel); a float64 model takes the plain
flip-and-cumsum scan per channel.

The field views (``number_density``, ``temperature``, ``vel``, ...) are
host numpy arrays, NaN outside the jet, as in the JAX model; the
diagnostic reductions (``diagnostic_maps``, ``occupancy_projections``,
``conservation_profiles``, ``velocity_midplane``) run on the model's device
and copy only their maps and profiles to the host.
"""
from __future__ import annotations

import copy
import hashlib
import os
import pickle
import runpy
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import constants as cnsts
from ..io import fits as fitsio
from ..ops import astronomy as astro
from ..ops import departure as dep
from ..ops import geometry as mgeom
from ..ops import kernels as kn
from ..ops import physics as mphys
from ..ops import radtrans as rt
from ..ops import rrls as mrrl
from ..utils import misc as miscf
from ..utils.logger import Log
from ..utils.pinned import HostPool
from ..utils.profiling import KernelTimer, count, span
from ..utils.validation import check_model_params
from . import ejection as ej
from . import grid as mgrid
from .fields import (Geometry, StaticFields, centre_rwp,
                     compute_static_fields, effective_radius,
                     travel_time_years, velocity)


class RTStatic(NamedTuple):
    """Epoch-independent RT precomputations (one pass per model).

    ``a``/``em_base`` are the full base cubes; ``a_t``/``em_t``/``tss_t``/
    ``seg`` are their jet-occupied-tile compactions feeding the epoch tile
    kernels, and ``walk`` the walk of both epoch tile kernels (single- and
    dual-base) and of the RRL tile kernel over them — ``None`` off the
    float32 burst path or when no tile is active.
    """
    a: torch.Tensor          # free-free base-opacity cube tau_ff_base
    em_base: torch.Tensor    # per-cell EM contribution (nd xi)^2 ds_pc
    tbar: torch.Tensor       # LOS-mean temperature map
    any_in: torch.Tensor     # jet silhouette (bool map)
    ts_signed: torch.Tensor  # packed launch time + jet side cube
    a_t: Optional[torch.Tensor] = None    # (n_act, 8, 64, 128)
    em_t: Optional[torch.Tensor] = None   # (n_act, 8, 64, 128)
    tss_t: Optional[torch.Tensor] = None  # (n_act, 8, 64, 128)
    seg: Optional[torch.Tensor] = None    # (n_act,) int64 xz-tile segments
    # kernels.segment_order's (order, seg_start) of seg, int32 on the device
    walk: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


class _OnDevice:
    """A NamedTuple of tensors (or of tuples of them) read on ``device``:
    each field is copied there the first time it is read, and kept.  A
    tensor already on ``device`` is not copied."""

    def __init__(self, src, device: torch.device):
        self._src, self._device, self._copies = src, device, {}

    def __getattr__(self, name):
        if name.startswith('_') or name not in type(self._src)._fields:
            raise AttributeError(name)
        if name not in self._copies:
            self._copies[name] = _to_device(getattr(self._src, name),
                                            self._device)
        return self._copies[name]


def _to_device(v, device):
    if isinstance(v, tuple):
        return tuple(_to_device(x, device) for x in v)
    return None if v is None else v.to(device)


# Sub-threshold fill factors / areas present as NaN at the public API
# boundary (classes.py:663-666's "sub-1e-6 -> NaN" convention).
FF_MIN = 1e-6


class JetModel:
    """Physical model of an ionised YSO jet (reference classes.py:42-1713)."""

    # ------------------------------------------------------------------ #
    # Construction / persistence
    # ------------------------------------------------------------------ #
    @classmethod
    def load_model(cls, model_file: str, dtype='auto',
                   device='cuda') -> "JetModel":
        """Rebuild a model from a saved state (classes.py:48-88); reads the
        checkpoints of either package."""
        model_file = os.path.expanduser(model_file)
        with open(model_file, 'rb') as f:
            loaded = pickle.load(f)
        new_jm = cls(loaded['params'], log=loaded.get('log'), dtype=dtype,
                     device=device)
        if loaded.get('ffs') is not None and loaded.get('areas') is not None:
            new_jm._inject_cached_ff(loaded['ffs'], loaded['areas'])
        new_jm.time = loaded.get('time', 0.0)
        return new_jm

    @staticmethod
    def lz_to_grid_dims(params: Dict) -> Tuple[int, int, int]:
        """classes.py:90-122 (see models.grid)."""
        return mgrid.lz_to_grid_dims(params)

    @staticmethod
    def py_to_dict(py_file: str) -> Dict:
        """Run an executable-python params file by path and validate its
        ``params`` (classes.py:124-142)."""
        if not os.path.exists(py_file):
            raise FileNotFoundError(py_file + " does not exist")
        params = runpy.run_path(os.path.abspath(py_file))['params']
        err = check_model_params(params)
        if err is not None:
            raise err
        return params

    @staticmethod
    def resolve_dtype(dtype, device) -> torch.dtype:
        """``'auto'`` (or None): float32 on CUDA, float64 on the CPU.
        ``'parity'``: float64, the configuration behind the JAX package's
        1e-9 continuum parity contract.  ``torch.float32`` and
        ``torch.float64`` pass through."""
        if dtype in ('auto', None):
            return (torch.float32 if torch.device(device).type == 'cuda'
                    else torch.float64)
        if dtype == 'parity':
            return torch.float64
        if dtype in (torch.float32, torch.float64):
            return dtype
        raise ValueError(f"dtype must be 'auto', 'parity', torch.float32 or "
                         f"torch.float64, got {dtype!r}")

    def __init__(self, params: Union[dict, str],
                 log: Union[None, Log] = None,
                 dtype='auto', device='cuda'):
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("JetModel(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        self._device = device

        if isinstance(params, dict):
            err = check_model_params(params)
            if err is not None:
                raise err
            self._params = params
        elif isinstance(params, str):
            self._params = JetModel.py_to_dict(params)
        else:
            raise TypeError("Supplied arg params must be dict or file path "
                            "(str)")

        self._dtype = JetModel.resolve_dtype(dtype, device)
        self._name = self.params['target']['name']
        self._csize = self.params['grid']['c_size']

        # Derived parameters (classes.py:169-181)
        g = self._params['geometry']
        pl = self._params['power_laws']
        mr0 = float(mgeom.mod_r_0(g['opang'], g['epsilon'], g['w_0']))
        q_n = mphys.q_n(g['epsilon'], pl['q_v'])
        g['mod_r_0'] = mr0
        pl['q_n'] = q_n
        pl['q_tau'] = mphys.q_tau(g['epsilon'], pl['q_x'], q_n, pl['q_T'])

        self._log = log if log is not None else Log(
            os.path.expanduser('~') + os.sep + 'temp.log', verbose=False)

        # Grid dimensions (classes.py:188-213)
        if self.params['grid'].get('l_z') is not None:
            nx, ny, nz = mgrid.lz_to_grid_dims(self.params)
            self.log.add_entry(
                "INFO",
                'For a (bipolar) jet length of {:.1f}", cell size of '
                '{:.2f}au and distance of {:.0f}pc, a grid size of '
                '(n_x, n_y, n_z) = ({}, {}, {}) voxels is calculated'.format(
                    self.params['grid']['l_z'],
                    self.params['grid']['c_size'],
                    self.params['target']['dist'], nx, ny, nz))
        else:
            nx = (self.params['grid']['n_x'] + 1) // 2 * 2
            ny = (self.params['grid']['n_y'] + 1) // 2 * 2
            nz = (self.params['grid']['n_z'] + 1) // 2 * 2
        self.params['grid']['n_x'] = nx
        self.params['grid']['n_y'] = ny
        self.params['grid']['n_z'] = nz
        self._nx, self._ny, self._nz = nx, ny, nz

        # Steady-state mass-loss rates (classes.py:228-242)
        props = self.params['properties']
        self._ss_jml_rb_frac = props['mlr_rj'] / props['mlr_bj']
        self._ss_jml_bj = props['mlr_bj'] * 1.989e30 / cnsts.YEAR
        self._ss_jml_rj = self._ss_jml_bj * self._ss_jml_rb_frac

        # n_0 is always (re-)derived from mlr_bj (classes.py:234-242)
        props['n_0'] = mphys.n_0_from_mlr(
            props['mlr_bj'], props['v_0'], g['w_0'], props['mu'],
            pl['q^d_n'], pl['q^d_v'], self.params['target']['R_1'],
            self.params['target']['R_2'])

        # Ejection events (classes.py:244-264)
        self._ejections: Dict[str, dict] = {}
        spec_r, spec_b = ej.build_ejection_specs(
            self.params, self._ss_jml_bj, self._ss_jml_rj)
        self._spec_r, self._spec_b = spec_r, spec_b
        which_arr = np.atleast_1d(np.asarray(self.params['ejection']['which']))
        for idx, t0 in enumerate(np.atleast_1d(
                np.asarray(self.params['ejection']['t_0'], dtype=float))):
            which = str(which_arr[idx])
            for side, ss in (('R', self._ss_jml_rj), ('B', self._ss_jml_bj)):
                if side in which.upper():
                    self._ejections[str(len(self._ejections) + 1)] = {
                        't_0': t0 * cnsts.YEAR,
                        'peak_jml': ss * self.params['ejection']['chi'][idx],
                        'half_life':
                            self.params['ejection']['hl'][idx] * cnsts.YEAR,
                        'which': side}

        self._time = 0.0
        # pinned host blocks of the numpy products (shared by replicas)
        self._host_pool = HostPool()
        self._replica_of: Optional[JetModel] = None
        self._fields: Optional[StaticFields] = None
        self._host_ff_cache = None  # (areas, ffs) host copies for save()
        self._reset_derived_caches()
        self._ts_pack_offset = 1.0  # finalised by _rt_static (ts can go
        #                             negative off-axis)
        self._has_bursts = (len(spec_r.t_0) + len(spec_b.t_0)) > 0

    def _reset_derived_caches(self):
        """Drop everything derived from the fields or the burst set: the
        RT statics and their tile compactions, the copies on other devices
        (:meth:`_replica`), and the memoised characteristic conditions and
        departure coefficients."""
        self._rt_static_cache: Optional[RTStatic] = None
        self._tile_ids_cache = None
        self._rrl_tiles_cache = None
        self._emergent_tiles_cache = None
        self._replicas: Dict[torch.device, JetModel] = {}
        self._char_cond_cache: Dict[float, tuple] = {}
        self._departure_cache: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------------ #
    # Core field computation (lazy, cached on the model's device)
    # ------------------------------------------------------------------ #
    @property
    def _grid_coords(self):
        return mgrid.grid_corner_coords(self._nx, self._ny, self._nz,
                                        self._csize, self._dtype,
                                        self._device)

    def _ensure_fields(self) -> StaticFields:
        if self._fields is None and self._replica_of is not None:
            self._fields = _OnDevice(self._replica_of._ensure_fields(),
                                     self._device)
        if self._fields is None:
            self._log.add_entry(
                "INFO", "Calculating cells' fill factors/projected areas "
                        "and physical fields")
            xx, yy, zz = self._grid_coords
            with KernelTimer("grid fill (fields + fill factors)",
                             self._log) as t:
                self._fields = compute_static_fields(
                    self._static_params(), xx, yy, zz, self._ss_jml_rb_frac,
                    with_time=self._has_bursts)
                t.set_result(self._fields.ff)
        return self._fields

    def _static_params(self) -> Dict:
        """Shallow copy of params with only scalar leaves (ejection arrays
        excluded — they live in the EjectionSpecs)."""
        p = self._params
        return {
            'target': {k: p['target'][k] for k in
                       ('dist', 'v_lsr', 'M_star', 'R_1', 'R_2')},
            'grid': {'c_size': p['grid']['c_size']},
            'geometry': dict(p['geometry']),
            'power_laws': dict(p['power_laws']),
            'properties': dict(p['properties']),
        }

    def _inject_cached_ff(self, ffs, areas):
        """Accept previously computed fill factors/areas from a checkpoint
        (classes.py:78-85); NaN-style inputs become masked zeros.  Only
        cells that both the checkpoint and the recomputed mask place inside
        carry the loaded values."""
        fields = self._ensure_fields()
        ffs = np.nan_to_num(np.asarray(ffs, dtype=np.float64), nan=0.0)
        areas = np.nan_to_num(np.asarray(areas, dtype=np.float64), nan=0.0)
        inside = torch.as_tensor(areas > 0, device=self._device) & \
            fields.inside
        zero = torch.zeros((), dtype=self._dtype, device=self._device)

        def load(a):
            return torch.where(inside, torch.as_tensor(
                a, device=self._device).to(self._dtype), zero)

        self._fields = fields._replace(ff=load(ffs), area=load(areas),
                                       inside=inside)
        self._host_ff_cache = None
        self._reset_derived_caches()  # derived from ff/area: recompute

    # ------------------------------------------------------------------ #
    # Simple properties (classes.py:363-381, 1654-1702)
    # ------------------------------------------------------------------ #
    @property
    def los_axis(self) -> int:
        """Axis of the (nx, ny, nz) cubes that runs along the line of
        sight."""
        return rt.LOS_AXIS

    @property
    def time(self) -> float:
        """Model time in seconds."""
        return self._time

    @time.setter
    def time(self, new_time: float):
        self._time = float(new_time)

    @property
    def log(self):
        return self._log

    @log.setter
    def log(self, new_log):
        self._log = new_log

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def csize(self) -> float:
        return self._csize

    @property
    def nx(self) -> int:
        return self._nx

    @property
    def ny(self) -> int:
        return self._ny

    @property
    def nz(self) -> int:
        return self._nz

    @property
    def params(self) -> Dict:
        return self._params

    @property
    def name(self) -> str:
        return self._name

    @property
    def ejections(self) -> Dict:
        return self._ejections

    def ss_jml(self, which: str) -> float:
        """Steady-state jet mass-loss rate [kg/s] (classes.py:1694-1702)."""
        if which == 'R':
            return self._ss_jml_rj
        if which == 'B':
            return self._ss_jml_bj
        if 'R' in which and 'B' in which:
            return self._ss_jml_rj + self._ss_jml_bj
        raise ValueError("which must be one of 'R', 'B', or 'RB'")

    def jml_t(self, which: str):
        """Time-dependent mass-loss rate callable [kg/s]
        (classes.py:383-397)."""
        def func(t):
            jml = 0.0
            if 'R' in which:
                jml = jml + self._spec_r.jml(t)
            if 'B' in which:
                jml = jml + self._spec_b.jml(t)
            return jml
        return func

    def add_ejection_event(self, t_0: float, peak_jml: float,
                           half_life: float, which: str):
        """Register a Gaussian ejection burst (classes.py:399-463).
        Args in SI seconds / kg/s, as the reference."""
        assert which in ('R', 'B')
        spec = self._spec_r if which == 'R' else self._spec_b
        new = ej.EjectionSpec(
            ss_jml=spec.ss_jml,
            t_0=np.append(spec.t_0, t_0),
            peak_jml=np.append(spec.peak_jml, peak_jml),
            half_life=np.append(spec.half_life, half_life))
        if which == 'R':
            self._spec_r = new
        else:
            self._spec_b = new
        self._ejections[str(len(self._ejections) + 1)] = {
            't_0': t_0, 'peak_jml': peak_jml, 'half_life': half_life,
            'which': which}
        was_burst_free = not self._has_bursts
        self._has_bursts = True
        # The statics hold tiles only on the burst path, and the memoised
        # EM-weighted conditions saw the old burst set's n_e.  A model built
        # burst-free filled its fields with with_time=False (ts = zeros:
        # every cell would burst at once), so those are made again with
        # travel times; the fill factors do not change.
        self._reset_derived_caches()
        if was_burst_free:
            self._fields = None
            self._host_ff_cache = None

    # ------------------------------------------------------------------ #
    # Coordinate grids (classes.py:465-569) — NaN-free by construction
    # ------------------------------------------------------------------ #
    @property
    def indices(self):
        return tuple(np.meshgrid(np.arange(self.nx), np.arange(self.ny),
                                 np.arange(self.nz), indexing='ij'))

    @property
    def ix(self):
        return self.indices[0]

    @property
    def iy(self):
        return self.indices[1]

    @property
    def iz(self):
        return self.indices[2]

    def _full_numpy(self, arrs):
        """Broadcast (nx, ny, nz) read-only numpy views of tensors."""
        shape = (self.nx, self.ny, self.nz)
        return tuple(np.broadcast_to(a.cpu().numpy(), shape) for a in arrs)

    @property
    def grid(self):
        return self._full_numpy(self._grid_coords)

    @property
    def xx(self):
        return self.grid[0]

    @property
    def yy(self):
        return self.grid[1]

    @property
    def zz(self):
        return self.grid[2]

    @property
    def xs(self):
        return self._grid_coords[0].cpu().numpy().ravel()

    @property
    def ys(self):
        return self._grid_coords[1].cpu().numpy().ravel()

    @property
    def zs(self):
        return self._grid_coords[2].cpu().numpy().ravel()

    def _centre_rwp(self, y_slice: slice = slice(None)):
        """Jet-frame (r, w, phi) of the cell centres as broadcast tensors on
        the model's device, for the y rows ``y_slice``."""
        xx, yy, zz = self._grid_coords
        half = self.csize / 2.0
        gm = Geometry.from_params(self._static_params())
        return centre_rwp(gm, xx + half, yy[:, y_slice, :] + half, zz + half)

    @property
    def grid_rwp(self):
        return self._full_numpy(self._centre_rwp())

    @property
    def rr(self):
        return self.grid_rwp[0]

    @property
    def ww(self):
        return self.grid_rwp[1]

    @property
    def pp(self):
        return self.grid_rwp[2]

    @property
    def rreff(self):
        rr, ww, _ = self._centre_rwp()
        rr, ww = torch.broadcast_tensors(rr, ww)
        gm = Geometry.from_params(self._static_params())
        return effective_radius(gm, rr, ww).cpu().numpy()

    # ------------------------------------------------------------------ #
    # Cached field views — NaN outside the jet, as the reference's API
    # ------------------------------------------------------------------ #
    def _nan_view(self, arr, mask=None) -> np.ndarray:
        if mask is None:
            mask = self._ensure_fields().inside
        nan = torch.full((), float('nan'), dtype=arr.dtype,
                         device=arr.device)
        return torch.where(mask, arr, nan).cpu().numpy()

    @property
    def fill_factor(self) -> np.ndarray:
        """classes.py:571-769 (NaN outside the jet boundary)."""
        f = self._ensure_fields()
        return self._nan_view(f.ff, f.ff > FF_MIN)

    @property
    def areas(self) -> np.ndarray:
        """classes.py:771-784."""
        f = self._ensure_fields()
        return self._nan_view(f.area, f.area > FF_MIN)

    @property
    def ts(self) -> np.ndarray:
        """Launch time of each cell's material: model time minus travel
        time [s], for every cell like the reference (classes.py:838-855 —
        unmasked).  A burst-free model fills its fields without travel
        times, so they are evaluated here instead."""
        f = self._ensure_fields()
        travel = f.ts
        if not self._has_bursts:
            rr, ww, _ = self._centre_rwp()
            travel = travel_time_years(
                Geometry.from_params(self._static_params()),
                self._static_params(), rr, ww) * cnsts.YEAR
            travel = travel.expand(f.ff.shape)
        return (self.time - travel).cpu().numpy()

    @property
    def chi_xyz(self) -> np.ndarray:
        """Burst factor per cell (classes.py:861-870) at the model time."""
        f = self._ensure_fields()
        return ej.chi_field(f.red, self.time - f.ts, self._spec_r,
                            self._spec_b).cpu().numpy()

    @property
    def number_density(self) -> np.ndarray:
        """Time-modulated number density [cm^-3] (classes.py:872-899)."""
        return self._nan_view(self._nd_chi(self._ensure_fields(), self.time))

    @property
    def mass_density(self) -> np.ndarray:
        """[g cm^-3] (classes.py:901-908)."""
        av_m = self.params['properties']['mu'] * cnsts.atomic_mass('H')
        return av_m * 1e3 * self.number_density

    @property
    def ion_fraction(self) -> np.ndarray:
        """classes.py:910-936."""
        return self._nan_view(self._ensure_fields().xi)

    @property
    def temperature(self) -> np.ndarray:
        """[K] (classes.py:942-996; au/cm slip fixed, see models.fields)."""
        return self._nan_view(self._ensure_fields().temp)

    @property
    def pressure(self) -> np.ndarray:
        """[Ba] (classes.py:1002-1007)."""
        return self.number_density * self.temperature * cnsts.K_B * 1e7

    @property
    def vel(self):
        """(vx, vy, vz) [km/s] (classes.py:1009-1099).  The full 3-D
        velocity is evaluated on demand (only the LOS component is part of
        the cached RT working set)."""
        f = self._ensure_fields()
        sp = self._static_params()
        gm = Geometry.from_params(sp)
        rr, ww, pp = self._centre_rwp()
        return tuple(self._nan_view(v) for v in velocity(
            gm, sp, rr, pp, effective_radius(gm, rr, ww), f.inside))

    # ------------------------------------------------------------------ #
    # Diagnostic reductions on the model's device: only the small maps and
    # profiles are copied to the host
    # ------------------------------------------------------------------ #
    def diagnostic_maps(self) -> Dict[str, np.ndarray]:
        """LOS diagnostics for the standard plots: nan-mean maps of number
        density, temperature, ionisation fraction and LOS velocity, plus
        the LOS fill-factor sum — ``np.nanmean(jm.<field>,
        axis=jm.los_axis)`` and so on, reduced on the device."""
        f = self._ensure_fields()
        los = rt.LOS_AXIS
        cnt = f.inside.sum(dim=los)
        pos = cnt > 0
        safe = cnt.clamp_min(1).to(f.temp.dtype)
        zero = torch.zeros((), dtype=f.temp.dtype, device=self._device)
        nan = torch.full_like(zero, float('nan'))

        def mean(v):
            return torch.where(pos, torch.where(f.inside, v, zero).sum(
                dim=los) / safe, nan)

        ffs = torch.where(f.ff > FF_MIN, f.ff, zero).sum(dim=los)
        maps = (mean(self._nd_chi(f, self.time)), mean(f.temp), mean(f.xi),
                mean(f.vy), ffs)
        return dict(zip(('n_e', 'T', 'x_i', 'v_los', 'ff_sum'),
                        (m.cpu().numpy() for m in maps)))

    def occupancy_projections(self) -> Dict[str, np.ndarray]:
        """Fill-factor sums along each grid axis — the three projected
        silhouettes of :func:`plotting.functions.geometry_plot`
        (functions.py:1019-1023)."""
        f = self._ensure_fields()
        ff = torch.where(f.ff > FF_MIN, f.ff, torch.zeros_like(f.ff))
        return {key: ff.sum(dim=axis).cpu().numpy()
                for axis, key in enumerate(('yz', 'xz', 'xy'))}

    def conservation_profiles(self) -> Dict[str, np.ndarray]:
        """Mass and angular momentum per signed-r slice along the jet —
        the conservation diagnostics behind ``diagnostic_plot``
        (plotting/functions.py:368-458), valid for any inclination and
        position angle: the per-cell mass and angular momentum about the
        jet axis (the azimuthal speed from the rotation law) are binned by
        signed jet radius with one ``index_add_``.  On a card that sum uses
        atomics, so its last bits depend on the order of the adds.

        Returns ``{'r': bin centres [au], 'mass': kg per csize-thick
        slice, 'angmom': kg m^2 s^-1 per slice}``.
        """
        f = self._ensure_fields()
        sp = self._static_params()
        gm = Geometry.from_params(sp)
        csize = self.csize
        # static bin layout: |r| is bounded by the grid's half-diagonal
        r_max = 0.5 * csize * float(np.sqrt(self._nx ** 2 + self._ny ** 2 +
                                            self._nz ** 2)) + csize
        nbins = 2 * int(np.ceil(r_max / csize))
        r_lo = -0.5 * nbins * csize
        cell_vol_cm3 = (csize * cnsts.AU * 1e2) ** 3
        m_part_kg = sp['properties']['mu'] * cnsts.atomic_mass('H')

        rr, ww, _ = self._centre_rwp()
        rr, ww, _ = torch.broadcast_tensors(rr, ww, f.ff)
        reff = effective_radius(gm, rr, ww)
        m = self._nd_chi(f, self.time) * f.ff * (cell_vol_cm3 * m_part_kg)
        vphi = mphys.v_rot(rr, reff, mgeom.rho(rr, gm.r_0, gm.mod_r_0),
                           gm.epsilon, sp['target']['M_star'])     # km/s
        ang = m * (vphi * 1e3) * (ww * cnsts.AU)                   # kg m^2/s
        zero = torch.zeros((), dtype=m.dtype, device=self._device)
        m = torch.where(f.inside, m, zero).ravel()
        ang = torch.where(f.inside, ang, zero).ravel()
        seg = torch.floor((rr - r_lo) / csize).clamp(0, nbins - 1).to(
            torch.int64).ravel()

        def binned(v):
            return torch.zeros(nbins, dtype=v.dtype,
                               device=self._device).index_add_(0, seg, v)

        rs = r_lo + csize * (np.arange(nbins) + 0.5)
        return {'r': rs, 'mass': binned(m).cpu().numpy(),
                'angmom': binned(ang).cpu().numpy()}

    def velocity_midplane(self) -> Tuple[np.ndarray, np.ndarray]:
        """(v_x, v_z) [km/s] on the mid-LOS plane (y index ny//2), computed
        on that plane alone; NaN outside the jet.  Feeds the velocity
        quiver of :func:`plotting.functions.model_plot` (the reference's
        own quiver overlay is disabled as broken,
        plotting/functions.py:594-637)."""
        f = self._ensure_fields()
        sp = self._static_params()
        gm = Geometry.from_params(sp)
        mid = self._ny // 2
        rr, ww, pp = self._centre_rwp(slice(mid, mid + 1))
        ins = f.inside[:, mid:mid + 1, :]
        vx, _, vz = velocity(gm, sp, rr, pp, effective_radius(gm, rr, ww),
                             ins)
        return self._nan_view(vx[:, 0, :], ins[:, 0, :]), \
            self._nan_view(vz[:, 0, :], ins[:, 0, :])

    def _rt_inputs(self):
        """(fields, n_es, ds) — building blocks for custom RT compositions
        (the sharding layer and tests)."""
        f = self._ensure_fields()
        n_es = self._nd_chi(f, self.time) * f.xi
        return f, n_es, rt.path_length_cm(f.ff, f.area, self.csize)

    # ------------------------------------------------------------------ #
    # Radiative transfer
    # ------------------------------------------------------------------ #
    def _use_reynolds_gaunt(self) -> bool:
        # classes.py:1388-1393: van Hoof scalar gaunt iff q_T == 0
        return self.params['power_laws']['q_T'] != 0.0

    def _rt_constants(self):
        return (self.params['properties']['T_0'],
                self._use_reynolds_gaunt(), self.csize,
                self.params['target']['dist'])

    def _use_tiles(self) -> bool:
        """The float32 burst path: per-epoch maps through the epoch
        kernels (compacted tiles, or the full grid when no tile is
        active).  Float64 and burst-free models take the plain sum."""
        return self._has_bursts and self._dtype == torch.float32

    def _chi2(self, f: StaticFields, t: float):
        """Squared burst factor — the only way epoch time enters the
        free-free/EM products (n_e is chi-modulated then squared,
        classes.py:872-899 + 1395)."""
        if self._has_bursts:
            chi = ej.chi_field(f.red, t - f.ts, self._spec_r, self._spec_b)
            return chi * chi
        return torch.ones((), dtype=self._dtype, device=self._device)

    def _active_tile_ids(self):
        """Cached (ids, seg) numpy arrays of jet-occupied tiles."""
        if self._tile_ids_cache is None:
            f = self._ensure_fields()
            bx, yc, bz = kn.TILE
            self._tile_ids_cache = kn.active_tiles(f.inside, bx, bz, yc)
        return self._tile_ids_cache

    def _rt_static(self) -> RTStatic:
        """Cached epoch-independent RT precomputations:

        - ``a``: free-free base-opacity cube tau_ff_base(nd * xi) — per
          epoch, tau = scale(nu) * sum_los a * chi^2
        - ``em_base``: per-cell EM contribution (nd * xi)^2 ds_pc
        - ``tbar``/``any_in``: LOS-mean temperature and jet silhouette
        - ``ts_signed``: launch time + jet side packed into one cube
        - on the float32 burst path, the jet-occupied tiles of ``a``,
          ``em_base`` and ``ts_signed``, their segment ids and the walk
          over each (x, z) tile position's tiles
          (:func:`kernels.segment_order`), so that no epoch does host work
          for it.
        """
        if self._rt_static_cache is None and self._replica_of is not None:
            src = self._replica_of
            self._rt_static_cache = _OnDevice(src._rt_static(),
                                              self._device)
            self._ts_pack_offset = src._ts_pack_offset
        if self._rt_static_cache is None:
            f = self._ensure_fields()
            t_0, reyn, csize, _ = self._rt_constants()

            # travel times can be NEGATIVE near the launch surface for
            # off-axis geometries; the packing offset must keep |tss| > 0
            self._ts_pack_offset = kn.pack_offset_for(float(f.ts.min()))

            n_es0 = f.nd * f.xi
            ds = rt.path_length_cm(f.ff, f.area, csize)
            a = rt.tau_ff_base(f.temp, n_es0, ds, f.inside, reyn)
            del n_es0, ds
            em_base = rt.emission_measure_base(f.nd, f.xi, f.ff, f.area,
                                               csize)
            tbar, any_in = rt.mean_temperature_map(f.temp, f.inside)
            ts_signed = kn.pack_launch_time(f.ts, f.red, self._dtype,
                                            self._ts_pack_offset)
            a_t = em_t = tss_t = seg_d = walk = None
            if self._use_tiles():
                ids, seg = self._active_tile_ids()
                if ids.size:
                    bx, yc, bz = kn.TILE
                    tile = dict(block_x=bx, block_z=bz, y_chunk=yc)
                    a_t = kn.gather_tiles(a, ids, **tile)
                    em_t = kn.gather_tiles(em_base, ids, **tile)
                    tss_t = kn.gather_tiles(ts_signed, ids, fill=1.0, **tile)
                    seg_d = torch.as_tensor(seg, dtype=torch.int64,
                                            device=self._device)
                    walk = self._tile_walk(seg)
            self._rt_static_cache = RTStatic(a, em_base, tbar, any_in,
                                             ts_signed, a_t, em_t, tss_t,
                                             seg_d, walk)
        return self._rt_static_cache

    def _replica(self, device) -> "JetModel":
        """This model read on ``device``, for the shards of
        :mod:`..parallel` and the fits' chains on other devices: a shallow
        copy with a time of its own, whose field cubes, RT statics and RRL
        tiles are this model's (made here first if need be), each copied
        to ``device`` the first time the copy reads it (nothing is copied
        where ``device`` is the model's own).  Its methods are the model's,
        so their products are the model's bit for bit on the same device.
        One copy per device, kept until the fields change; the memoised
        characteristic conditions and departure coefficients are
        shared."""
        device = torch.device(device)
        rep = self._replicas.get(device)
        if rep is None:
            rep = copy.copy(self)
            rep._device = device
            rep._fields = None
            rep._rt_static_cache = rep._rrl_tiles_cache = None
            rep._emergent_tiles_cache = None
            rep._replicas = {}
            rep._replica_of = self
            self._replicas[device] = rep
        return rep

    def _tile_walk(self, seg):
        """:func:`kernels.segment_order` of the tiles' segment ids, as int32
        tensors on the model's device: the walk of the epoch tile kernels
        and of the RRL tile kernel over each (x, z) tile position's
        tiles."""
        bx, _, bz = kn.TILE
        return tuple(torch.as_tensor(w, device=self._device)
                     for w in kn.segment_order(
                         seg, -(-self._nx // bx) * -(-self._nz // bz)))

    def _burst_tuple(self):
        """Burst parameters for the epoch kernels: (t0 [s], 1/(2 sigma^2),
        relative amplitude, is_red) per burst — the data behind
        models/ejection.chi_field."""
        out = []
        for spec, is_red in ((self._spec_r, True), (self._spec_b, False)):
            for t0, peak, sig in zip(spec.t_0, spec.peak_jml, spec.sigma):
                out.append((float(t0), float(1.0 / (2.0 * sig ** 2)),
                            float((peak - spec.ss_jml) / spec.ss_jml),
                            is_red))
        return tuple(out)

    def _epoch_base_map(self, kind: str, f: StaticFields, st: RTStatic,
                        t: float):
        """LOS-collapsed sum_y base * chi(t)^2 for ``kind`` in {'a', 'em'}:
        the compacted-tile kernel when tiles are active, the full-grid
        kernel otherwise on the float32 burst path, the plain sum
        elsewhere."""
        base = st.a if kind == 'a' else st.em_base
        if self._use_tiles():
            off = self._ts_pack_offset
            if st.seg is not None:
                base_t = st.a_t if kind == 'a' else st.em_t
                return kn.epoch_base_map_tiles(base_t, st.tss_t, st.seg, t,
                                               self._burst_tuple(),
                                               self._nx, self._nz,
                                               pack_offset=off, walk=st.walk)
            return kn.epoch_base_map_full(base, st.ts_signed, t,
                                          self._burst_tuple(),
                                          pack_offset=off)
        return torch.sum(base * self._chi2(f, t), dim=rt.LOS_AXIS)

    def _epoch_base_maps_both(self, f: StaticFields, st: RTStatic,
                              t: float):
        """BOTH collapsed epoch maps (sum_y a*chi^2, sum_y em_base*chi^2)
        from one chi evaluation: the dual-base tile kernel on the float32
        burst path (two full-grid kernel passes when no tile is active), a
        shared-chi plain pass elsewhere."""
        if self._use_tiles():
            if st.seg is not None:
                return kn.epoch_base_maps2_tiles(
                    st.a_t, st.em_t, st.tss_t, st.seg, t,
                    self._burst_tuple(), self._nx, self._nz,
                    pack_offset=self._ts_pack_offset, walk=st.walk)
            return (self._epoch_base_map('a', f, st, t),
                    self._epoch_base_map('em', f, st, t))
        chi2 = self._chi2(f, t)
        return (torch.sum(st.a * chi2, dim=rt.LOS_AXIS),
                torch.sum(st.em_base * chi2, dim=rt.LOS_AXIS))

    def _freqs(self, freq) -> torch.Tensor:
        return torch.as_tensor(np.atleast_1d(np.asarray(freq, dtype=float)),
                               device=self._device).to(self._dtype)

    def products_to_host(self, maps) -> Tuple[np.ndarray, ...]:
        """An RT run's maps, computed on this model's device, as numpy
        arrays on the host: the one copy-out of every run's products (the
        model's own runs with ``as_numpy=True``, ``Pipeline.execute_run``
        and :mod:`..parallel.fanout`).

        On a CUDA model they are copied into blocks of the model's pinned
        host pool (:mod:`..utils.pinned`, shared by its replicas), with one
        synchronisation: a block is recycled for a later run once every
        array that views it has been dropped, and the pool keeps at most
        twice the bytes of its largest run's maps free.  On the CPU they
        are views of the maps.  Counts the bytes, and on a CUDA model the
        maps and the blocks the pool had to make."""
        with span('rajepy.rt.products_out'):
            if self._device.type == 'cuda':
                out, made = self._host_pool.copy_out(maps)
                count('rt.products_out_maps', len(out))
                count('rt.products_out_pinned_new', made)
            else:
                out = tuple(m.numpy() for m in maps)
        count('rt.products_out_bytes', sum(a.nbytes for a in out))
        return out

    def continuum_rt_products(self, freq, as_numpy: bool = True):
        """The complete per-run continuum RT stage — EM map, per-channel
        optical-depth maps and flux maps — from ONE epoch pass: the burst
        factor is evaluated once and both base cubes stream through the
        dual-base kernel.

        Equivalent to ``emission_measure`` + ``optical_depth_ff`` +
        ``flux_ff`` (the reference's per-run sequence,
        classes.py:2397-2423).  Returns numpy ``(em, taus, fluxes)``, or
        the device tensors with ``as_numpy=False``.

        The numpy maps come from :meth:`products_to_host`: on a CUDA
        model, views of pinned host memory that the model recycles once
        the caller has dropped them; on the CPU, views of the maps.
        """
        with span('rajepy.rt.run'):
            with span('rajepy.rt.statics'):
                f = self._ensure_fields()
                st = self._rt_static()
            t_0, reyn, csize, dist = self._rt_constants()
            freqs = self._freqs(freq)
            with span('rajepy.rt.epoch_maps'):
                a_map, em = self._epoch_base_maps_both(f, st, self.time)
            with span('rajepy.rt.channel_stage'):
                scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
                taus = scale[:, None, None] * a_map[None]
                fluxes = rt.flux_ff_maps(freqs, taus, st.tbar, st.any_in,
                                         csize, dist)
            count('rt.runs')
            maps = (em, taus, fluxes)
            return self.products_to_host(maps) if as_numpy else maps

    def emission_measure(self, savefits: Union[bool, str] = False
                         ) -> np.ndarray:
        """EM map [pc cm^-6] (classes.py:1101-1128)."""
        f = self._ensure_fields()
        st = self._rt_static()
        em = self._epoch_base_map('em', f, st, self.time).cpu().numpy()
        if savefits:
            self.save_fits(miscf.reorder_axes(em, ra_axis=0, dec_axis=1),
                           savefits, 'em')
        return em

    def _continuum_product(self, kind: str, freq, collapse: bool = True):
        """tau/intensity/flux product for the channels ``freq`` from the
        cached static base cube (compacted tiles on the float32 burst
        path)."""
        f = self._ensure_fields()
        st = self._rt_static()
        t_0, reyn, csize, dist = self._rt_constants()
        freqs = self._freqs(freq)
        scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
        if kind == 'tau' and not collapse:
            return scale[:, None, None, None] * \
                (st.a * self._chi2(f, self.time))[None]
        base_map = self._epoch_base_map('a', f, st, self.time)
        taus = scale[:, None, None] * base_map[None]
        if kind == 'tau':
            return taus
        if kind == 'intensity':
            return rt.intensity_ff_maps(freqs, taus, st.tbar, st.any_in)
        return rt.flux_ff_maps(freqs, taus, st.tbar, st.any_in, csize, dist)

    def optical_depth_ff(self, freq, savefits: Union[bool, str] = False,
                         collapse: bool = True) -> np.ndarray:
        """Free-free optical depth (classes.py:1353-1447): collapsed
        (nx, nz) maps per channel, or the full per-cell cube."""
        scalar = np.isscalar(freq)
        tff = self._continuum_product('tau', freq, collapse).cpu().numpy()
        if savefits:
            self._save_rt_fits(tff, savefits, 'tau', freq, scalar, collapse)
        return tff[0] if scalar else tff

    def intensity_ff(self, freq, savefits: Union[bool, str] = False
                     ) -> np.ndarray:
        """Free-free intensity [W m^-2 Hz^-1 sr^-1] (classes.py:1449-1496)."""
        scalar = np.isscalar(freq)
        ints = self._continuum_product('intensity', freq).cpu().numpy()
        if savefits:
            self._save_rt_fits(ints, savefits, 'intensity', freq, scalar,
                               True)
        return ints[0] if scalar else ints

    def flux_ff(self, freq, savefits: Union[bool, str] = False) -> np.ndarray:
        """Free-free flux [Jy/pixel] (classes.py:1498-1541)."""
        scalar = np.isscalar(freq)
        fluxes = self._continuum_product('flux', freq).cpu().numpy()
        if savefits:
            self._save_rt_fits(fluxes, savefits, 'flux', freq, scalar, True)
        return fluxes[0] if scalar else fluxes

    # ------------------------------------------------------------------ #
    # Radio recombination lines (jetmodel.py:1158-1595)
    # ------------------------------------------------------------------ #
    def _use_fused_rrl(self) -> bool:
        """A float32 model takes the RRL kernels (the tile kernel on
        compacted tiles, the cube kernel on the full grid when no tile is
        active) on either device, with or without bursts; float64 takes
        the plain per-channel loop (jetmodel.py:1158-1169)."""
        return self._dtype == torch.float32

    def _nd_chi(self, f: StaticFields, t: float):
        """Time-modulated number density (masked zeros)."""
        if self._has_bursts:
            return f.nd * ej.chi_field(f.red, t - f.ts, self._spec_r,
                                       self._spec_b)
        return f.nd

    def _chi_from_packed(self, tss, t: float):
        """Burst factor recovered from packed launch-time tiles (side =
        sign, time = |tss| - offset)."""
        lt = t - (tss.abs() - self._ts_pack_offset)
        return ej.chi_field(tss < 0.0, lt, self._spec_r, self._spec_b)

    def _rrl_tiles(self):
        """Cached compacted jet-occupied float32 field tiles for the RRL
        tile kernel: (temp_t, vy_t, ndxi_t, ds_t, inside_t, tss_t, order,
        seg_start), or None when the grid holds no jet cell
        (jetmodel.py:1181-1219).  The tiles keep the epoch compaction's
        order, and its packed launch-time tiles are reused when it made
        them; ``(order, seg_start)`` (int32, :func:`kernels.segment_order`)
        is the kernel's walk over each (x, z) tile position's tiles, the
        epoch compaction's own where it made one."""
        if self._rrl_tiles_cache is None and self._replica_of is not None:
            tiles = self._replica_of._rrl_tiles() or ()
            self._rrl_tiles_cache = _to_device(tuple(tiles), self._device)
        if self._rrl_tiles_cache is None:
            f = self._ensure_fields()
            st = self._rt_static()
            ids, seg = self._active_tile_ids()
            if ids.size == 0:
                self._rrl_tiles_cache = ()
            else:
                f32 = torch.float32
                bx, yc, bz = kn.TILE
                tile = dict(block_x=bx, block_z=bz, y_chunk=yc)
                ds = rt.path_length_cm(f.ff, f.area, self.csize)
                tss_t = st.tss_t if st.tss_t is not None else \
                    kn.gather_tiles(st.ts_signed.to(f32), ids, fill=1.0,
                                    **tile)
                order, seg_start = st.walk if st.walk is not None else \
                    self._tile_walk(seg)
                self._rrl_tiles_cache = (
                    kn.gather_tiles(f.temp.to(f32), ids, fill=1.0, **tile),
                    kn.gather_tiles(f.vy.to(f32), ids, **tile),
                    kn.gather_tiles((f.nd * f.xi).to(f32), ids, **tile),
                    kn.gather_tiles(ds.to(f32), ids, **tile),
                    kn.gather_tiles(f.inside, ids, fill=False, **tile),
                    tss_t, order, seg_start)
        return self._rrl_tiles_cache or None

    @staticmethod
    def _nonlte_tau(st: RTStatic, freqs, tau_l, b_n1, b_n2):
        """Stimulated-corrected non-LTE line opacity b_n1 beta tau_L*
        (G&S 2.141), from the one ops-level definition."""
        return rt.tau_rrl_maps_nonlte(freqs, st.tbar, st.any_in, tau_l,
                                      b_n1, b_n2)

    def _tau_rrl_dispatch(self, coeffs, tiles, fused: bool,
                          f: StaticFields, t: float, freqs):
        """The RRL line-opacity dispatch shared by :meth:`_rrl_kernel` and
        :meth:`rrl_rt_products` (jetmodel.py:1361-1385): compacted tiles
        through the tile kernel -> the full grid through the cube kernel
        (float32) -> the plain per-channel loop (float64)."""
        if tiles is not None:
            temp_t, vy_t, ndxi_t, ds_t, inside_t, tss_t, order, seg_start = \
                tiles
            if self._has_bursts:
                n_es_t = ndxi_t * self._chi_from_packed(tss_t, t)
            else:
                n_es_t = ndxi_t
            return rt.tau_rrl_maps_tiles(coeffs, freqs, temp_t, n_es_t, vy_t,
                                         ds_t, inside_t, order, seg_start,
                                         self._nx, self._nz)
        n_es = self._nd_chi(f, t) * f.xi
        ds = rt.path_length_cm(f.ff, f.area, self.csize)
        if fused:
            return rt.tau_rrl_maps_fused(coeffs, freqs, f.temp, n_es, f.vy,
                                         ds, f.inside)
        return rt.tau_rrl_maps(coeffs, freqs, f.temp, n_es, f.vy, ds,
                               f.inside)

    def _rrl_kernel(self, line: str, kind: str, freqs, b_n1, b_n2,
                    collapse: bool = True, nonlte: bool = False):
        """RRL tau (``kind='tau'``) or intensity product for the channels
        ``freqs`` at the model time (jetmodel.py:1231-1287).  ``b_n1``/
        ``b_n2`` are the departure coefficients of the non-LTE mode (1.0
        for LTE)."""
        t_0, reyn, csize, _ = self._rt_constants()
        coeffs = rt.RRLCoeffs(line)
        fused = self._use_fused_rrl()
        f = self._ensure_fields()
        st = self._rt_static()
        t = self.time
        if kind == 'tau' and not collapse:
            n_es = self._nd_chi(f, t) * f.xi
            ds = rt.path_length_cm(f.ff, f.area, csize)
            return rt.tau_rrl_cube(coeffs, freqs, f.temp, n_es, f.vy, ds,
                                   f.inside)
        tiles = self._rrl_tiles() if fused else None
        tau_l = self._tau_rrl_dispatch(coeffs, tiles, fused, f, t, freqs)
        if kind == 'tau':
            if not nonlte:
                return tau_l
            return self._nonlte_tau(st, freqs, tau_l, b_n1, b_n2)
        if fused:
            # continuum opacity from the cached factorised base
            scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
            tau_c = scale[:, None, None] * \
                self._epoch_base_map('a', f, st, t)[None]
        else:
            n_es = self._nd_chi(f, t) * f.xi
            ds = rt.path_length_cm(f.ff, f.area, csize)
            tau_c = rt.tau_ff_maps(freqs, f.temp, n_es, ds, f.inside, t_0,
                                   reyn)
        if nonlte:
            return rt.intensity_rrl_maps_nonlte(freqs, st.tbar, tau_c,
                                                tau_l, st.any_in, b_n1,
                                                b_n2)
        return rt.intensity_rrl_maps(freqs, st.tbar, tau_c, tau_l,
                                     st.any_in)

    def rrl_rt_products(self, line: str, freq, contsub: bool = False,
                        lte: bool = True, departure_coeffs=None,
                        as_numpy: bool = True):
        """The complete per-run RRL RT stage — EM map, line optical-depth
        maps and line(+continuum when ``contsub=False``) flux maps — with
        the line-opacity chain evaluated once for both products and the
        continuum opacity and EM from one dual-base epoch pass
        (jetmodel.py:1289-1359; the reference's per-run sequence at
        classes.py:2437-2450).  Returns numpy ``(em, tau_l, fluxes)``, or
        the device tensors with ``as_numpy=False``; the numpy maps come
        from :meth:`products_to_host`.

        ``lte=False`` swaps in the G&S non-LTE slab composition: tau
        becomes the stimulated-corrected line opacity b_n1 beta tau_L* and
        the flux uses the eta/beta forms, with departure coefficients
        derived from the bundled table (:meth:`departure_coefficients`)
        or supplied.
        """
        with span('rajepy.rt.run'):
            b_n1, b_n2 = self._check_nonlte(lte, departure_coeffs, line)
            t_0, reyn, csize, dist = self._rt_constants()
            coeffs = rt.RRLCoeffs(line)
            fused = self._use_fused_rrl()
            with span('rajepy.rt.statics'):
                tiles = self._rrl_tiles() if fused else None
                f = self._ensure_fields()
                st = self._rt_static()
            t = self.time
            freqs = self._freqs(freq)
            with span('rajepy.rt.line_opacity'):
                tau_l = self._tau_rrl_dispatch(coeffs, tiles, fused, f, t,
                                               freqs)
            with span('rajepy.rt.epoch_maps'):
                a_map, em = self._epoch_base_maps_both(f, st, t)
            with span('rajepy.rt.channel_stage'):
                scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
                if lte:
                    # a float32 model takes the channel-stage kernel's
                    # wrapper, as it takes the RRL kernels; float64 the
                    # plain chain
                    stage = (kn.rrl_flux_maps if fused else
                             rt.rrl_flux_maps_lte)
                    tau_out = tau_l
                    fluxes = stage(freqs, scale, a_map, st.tbar, st.any_in,
                                   tau_l, csize, dist, contsub)
                else:
                    tau_c = scale[:, None, None] * a_map[None]
                    tau_out = self._nonlte_tau(st, freqs, tau_l, b_n1, b_n2)
                    ints = rt.intensity_rrl_maps_nonlte(
                        freqs, st.tbar, tau_c, tau_l, st.any_in, b_n1, b_n2)
                    fluxes = ints * rt.flux_scale_jy(csize, dist)
                    if not contsub:
                        fluxes = fluxes + rt.flux_ff_maps(
                            freqs, tau_c, st.tbar, st.any_in, csize, dist)
            count('rt.runs')
            maps = (em, tau_out, fluxes)
            return self.products_to_host(maps) if as_numpy else maps

    def characteristic_conditions(self):
        """Emission-measure-weighted (T_e [K], n_e [cm^-3]) over the jet at
        the current model time (n_e averaged in log space), memoised per
        model time (jetmodel.py:1387-1422)."""
        key = float(self.time)
        hit = self._char_cond_cache.get(key)
        if hit is not None:
            return hit
        f = self._ensure_fields()
        n_e = self._nd_chi(f, self.time) * f.xi
        w = torch.where(f.inside, n_e * n_e, torch.zeros_like(n_e))
        wsum = torch.sum(w).clamp_min(1e-30)
        t_char = torch.sum(w * f.temp) / wsum
        safe_ne = torch.where(f.inside, n_e.clamp_min(1e-30),
                              torch.ones_like(n_e))
        ln_char = torch.sum(w * torch.log10(safe_ne)) / wsum
        out = (float(t_char), 10.0 ** float(ln_char))
        self._char_cond_cache[key] = out
        return out

    def departure_coefficients(self, line: str):
        """(b_n1, b_n2) for ``line`` from the bundled case-B hydrogenic
        b_n(n, T_e, n_e) table (ops.departure) at the jet's
        emission-weighted characteristic conditions: what ``lte=False``
        uses when no explicit ``departure_coeffs`` are passed
        (jetmodel.py:1424-1460).  Memoised per (line, model time)."""
        key = (line, float(self.time))
        hit = self._departure_cache.get(key)
        if hit is not None:
            return hit
        _, n, dn = mrrl.rrl_parser(line)
        t_char, ne_char = self.characteristic_conditions()
        b_n1, b_n2 = dep.b_n_pair(n, dn, t_char, ne_char)
        self._log.add_entry(
            "INFO",
            "Departure coefficients for {}: b_n1 = {:.4f}, b_n2 = {:.4f} "
            "(case-B table at EM-weighted T_e = {:.0f} K, "
            "n_e = {:.2e} cm^-3)".format(line, b_n1, b_n2, t_char,
                                         ne_char),
            timestamp=False)
        self._departure_cache[key] = (b_n1, b_n2)
        return b_n1, b_n2

    def departure_coefficient_systematic(self, line: str):
        """(s_n1, s_n2): the collisional-rate-prescription systematic of
        :meth:`departure_coefficients` (ops.departure.b_n_systematic)."""
        _, n, dn = mrrl.rrl_parser(line)
        t_char, ne_char = self.characteristic_conditions()
        return dep.b_n_pair_systematic(n, dn, t_char, ne_char)

    def departure_coefficients_at_scale(self, line: str, which: str):
        """(b_n1, b_n2) from the rate-scale-band edge tables (``which`` in
        'lo'/'hi'/'central') at the jet's characteristic conditions."""
        _, n, dn = mrrl.rrl_parser(line)
        t_char, ne_char = self.characteristic_conditions()
        return dep.b_n_pair(n, dn, t_char, ne_char, which)

    def departure_coefficient_maps(self, line: str):
        """Per-sightline (b_n1, b_n2) numpy maps, shape (nx, nz): the
        case-B table at each LOS column's EM-weighted (T_e, n_e); b = 1
        where the column holds no jet cell (jetmodel.py:1484-1518).
        Accepted directly as ``departure_coeffs=``."""
        _, n, dn = mrrl.rrl_parser(line)
        f = self._ensure_fields()
        n_e = self._nd_chi(f, self.time) * f.xi
        w = torch.where(f.inside, n_e * n_e, torch.zeros_like(n_e))
        wsum = torch.sum(w, dim=rt.LOS_AXIS)
        any_in = wsum > 0.0
        ws = torch.where(any_in, wsum, torch.ones_like(wsum))
        t_map = torch.sum(w * f.temp, dim=rt.LOS_AXIS) / ws
        safe_ne = torch.where(f.inside, n_e.clamp_min(1e-30),
                              torch.ones_like(n_e))
        ln_map = torch.sum(w * torch.log10(safe_ne), dim=rt.LOS_AXIS) / ws
        t_map, ln_map, any_in = (a.cpu().numpy() for a in
                                 (t_map, ln_map, any_in))
        t_q = np.where(any_in, t_map, 1e4)
        ne_q = 10.0 ** np.where(any_in, ln_map, 4.0)
        b1 = np.where(any_in, dep.b_n(n, t_q, ne_q), 1.0)
        b2 = np.where(any_in, dep.b_n(n + int(dn), t_q, ne_q), 1.0)
        return b1, b2

    def _check_nonlte(self, lte, departure_coeffs, line):
        """(b_n1, b_n2): 1 for LTE, the user-supplied pair (scalars, or
        per-sightline (nx, nz) maps as tensors on the model's device), or
        the table-derived scalar pair (jetmodel.py:1520-1534)."""
        if lte:
            return 1.0, 1.0
        if departure_coeffs is None:
            return self.departure_coefficients(line)
        b_n1, b_n2 = departure_coeffs
        if np.ndim(b_n1) or np.ndim(b_n2):
            def as_t(b):
                return torch.as_tensor(np.asarray(b, dtype=np.float64),
                                       device=self._device).to(self._dtype)
            return as_t(b_n1), as_t(b_n2)
        return float(b_n1), float(b_n2)

    def optical_depth_rrl(self, rrl: str, freq, lte: bool = True,
                          savefits: Union[bool, str] = False,
                          collapse: bool = True,
                          departure_coeffs=None) -> np.ndarray:
        """RRL optical depth (classes.py:1130-1229).  ``lte=False`` returns
        the non-LTE line opacity b_n1 beta tau_L* (beyond the reference,
        which raises on lte=False)."""
        b_n1, b_n2 = self._check_nonlte(lte, departure_coeffs, rrl)
        if not lte and not collapse:
            raise ValueError("non-LTE opacities are slab quantities: "
                             "collapse=False is LTE-only")
        scalar = np.isscalar(freq)
        taus = self._rrl_kernel(rrl, 'tau', self._freqs(freq), b_n1, b_n2,
                                collapse, nonlte=not lte).cpu().numpy()
        if savefits:
            self._save_rt_fits(taus, savefits, 'tau', freq, scalar, collapse)
        return taus[0] if scalar else taus

    def intensity_rrl(self, rrl: str, freq, lte: bool = True,
                      savefits: Union[bool, str] = False,
                      departure_coeffs=None) -> np.ndarray:
        """RRL intensity (classes.py:1231-1290, each channel at its own
        frequency); ``lte=False`` evaluates the non-LTE slab form (G&S
        eqs. 2.130/2.139/2.141)."""
        b_n1, b_n2 = self._check_nonlte(lte, departure_coeffs, rrl)
        scalar = np.isscalar(freq)
        ints = self._rrl_kernel(rrl, 'intensity', self._freqs(freq), b_n1,
                                b_n2, nonlte=not lte).cpu().numpy()
        if savefits:
            self._save_rt_fits(ints, savefits, 'intensity', freq, scalar,
                               True)
        return ints[0] if scalar else ints

    def flux_rrl(self, rrl: str, freq, lte: bool = True,
                 contsub: bool = True,
                 savefits: Union[bool, str] = False,
                 departure_coeffs=None) -> np.ndarray:
        """RRL flux [Jy/pixel], optionally with continuum
        (classes.py:1292-1351)."""
        scalar = np.isscalar(freq)
        freqs = np.atleast_1d(np.asarray(freq, dtype=float))
        ints = self.intensity_rrl(rrl, freqs, lte=lte,
                                  departure_coeffs=departure_coeffs)
        fluxes = ints * float(rt.flux_scale_jy(
            self.csize, self.params['target']['dist']))
        if not contsub:
            fluxes = fluxes + self.flux_ff(freqs)
        if savefits:
            self._save_rt_fits(fluxes, savefits, 'flux', freq, scalar, True)
        return fluxes[0] if scalar else fluxes

    # ------------------------------------------------------------------ #
    # Ordered RT along the LOS (jetmodel.py:1600-1711)
    # ------------------------------------------------------------------ #
    def _emergent_tiles(self):
        """Cached compacted observer-ordered float32 tiles for the emergent
        tile kernel: (temp_t, a_t, tss_t, seg, seg_start, it, kt, n_seg,
        n_xt, n_zt), or None when the grid holds no jet cell.  The cubes
        are flipped along the LOS so that y=0 faces the observer, one at a
        time, then compacted in scan order."""
        if self._emergent_tiles_cache is None:
            f = self._ensure_fields()
            st = self._rt_static()
            bx, yc, bz = kn.TILE
            tile = dict(block_x=bx, block_z=bz, y_chunk=yc)
            ids, seg, it, kt = kn.active_tiles_scan_order(
                torch.flip(f.inside, [1]), **tile)
            if ids.size == 0:
                self._emergent_tiles_cache = ()
            else:
                f32 = torch.float32

                def flipped_tiles(cube, fill=0.0):
                    return kn.gather_tiles(torch.flip(cube, [1]).to(f32),
                                           ids, fill=fill, **tile)

                safe_t = torch.where(f.inside, f.temp,
                                     torch.ones_like(f.temp))
                temp_t = flipped_tiles(safe_t, fill=1.0)
                del safe_t
                n_seg = int(seg.max()) + 1
                dev = self._device
                self._emergent_tiles_cache = (
                    temp_t, flipped_tiles(st.a),
                    flipped_tiles(st.ts_signed, fill=1.0),
                    torch.as_tensor(seg, dtype=torch.int64, device=dev),
                    torch.as_tensor(kn.segment_starts(seg, n_seg),
                                    device=dev),
                    torch.as_tensor(it, dtype=torch.int64, device=dev),
                    torch.as_tensor(kt, dtype=torch.int64, device=dev),
                    n_seg, -(-self._nx // bx), -(-self._nz // bz))
        return self._emergent_tiles_cache or None

    def _emergent_channels(self, freqs):
        """(cnu, hnuk, tau_scale) of the emergent kernels in float32, from
        the model's (float32-rounded) channel frequencies: cnu = 2 h nu^3 /
        c^2 and hnuk = h nu / k formed in float64, then cast
        (jetmodel.py:1647-1652)."""
        t_0, reyn, _, _ = self._rt_constants()
        f32 = torch.float32
        scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
        freqs64 = freqs.to(torch.float64)
        cnu = 2.0 * cnsts.H_CGS * freqs64 ** 3 / cnsts.C_CGS ** 2
        hnuk = cnsts.H_CGS * freqs64 / cnsts.K_CGS
        return cnu.to(f32), hnuk.to(f32), scale.to(f32)

    def _emergent_maps(self, freq) -> torch.Tensor:
        """(n_chan, nx, nz) emergent free-free intensity on the model's
        device [W m^-2 Hz^-1 sr^-1]: the emergent tile kernel on compacted
        observer-ordered tiles -> the full-grid kernel when no tile is
        active (float32) -> the plain scan per channel (float64)."""
        f = self._ensure_fields()
        freqs = self._freqs(freq)
        t = self.time
        fused = self._use_fused_rrl()
        tiles = self._emergent_tiles() if fused else None
        if tiles is not None:
            temp_t, a_t, tss_t, _, seg_start, it, kt = tiles[:7]
            inten, _ = kn.emergent_ff_tiles(
                *self._emergent_channels(freqs), temp_t, a_t, tss_t,
                seg_start, it, kt, t, self._burst_tuple(), self._nx,
                self._nz, pack_offset=self._ts_pack_offset)
            return inten * 1e-7 * 1e4
        base = self._rt_static().a * self._chi2(f, t)
        safe_t = torch.where(f.inside, f.temp, torch.ones_like(f.temp))
        if fused:
            f32 = torch.float32
            inten, _ = kn.emergent_ff_full(*self._emergent_channels(freqs),
                                           safe_t.to(f32), base.to(f32))
            return inten * 1e-7 * 1e4
        t_0, reyn, _, _ = self._rt_constants()
        scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
        ints = []
        for c in range(freqs.shape[0]):
            src = mphys.blackbody_nu(freqs[c], safe_t)
            src = torch.where(f.inside, src, torch.zeros_like(src))
            ints.append(rt.transfer_scan(src, scale[c] * base))
        return torch.stack(ints) * 1e-7 * 1e4

    def emergent_intensity_ff(self, freq) -> np.ndarray:
        """Emergent free-free intensity from the ordered transfer integral
        sum S_i e^-tau (1-e^-dtau) along the LOS, in W m^-2 Hz^-1 sr^-1
        (jetmodel.py:1635-1711).  Reduces to the reference's slab form for
        an isothermal jet."""
        scalar = np.isscalar(freq)
        ints = self._emergent_maps(freq).cpu().numpy()
        return ints[0] if scalar else ints

    # ------------------------------------------------------------------ #
    # FITS output (classes.py:1543-1652)
    # ------------------------------------------------------------------ #
    def _save_rt_fits(self, data: np.ndarray, savefits: str, image_type: str,
                      freq, scalar: bool, collapse: bool):
        """Reorder axes per the reference's conventions and write."""
        if scalar:
            img = data[0]
            if collapse or img.ndim == 2:
                out = miscf.reorder_axes(img, ra_axis=0, dec_axis=1)
                los = False
            else:
                out = miscf.reorder_axes(img, ra_axis=0, dec_axis=2,
                                         axis3=1, axis3_type='y')
                los = True
            self.save_fits(out, savefits, image_type,
                           freq if np.ndim(freq) else [freq],
                           los_axis3=los)
        else:
            if collapse or data.ndim == 3:
                out = miscf.reorder_axes(data, ra_axis=1, dec_axis=2,
                                         axis3=0, axis3_type='freq')
                los = False
            else:
                out = miscf.reorder_axes(data, ra_axis=1, dec_axis=3,
                                         axis3=2, axis3_type='y',
                                         axis4=0, axis4_type='freq')
                los = True
            self.save_fits(out, savefits, image_type, freq,
                           los_axis3=los)

    def save_fits(self, data: np.ndarray, filename: str, image_type: str,
                  freq=None, los_axis3: bool = False):
        """Write a 2-D/3-D/4-D FITS image with the reference's WCS/units
        header (classes.py:1543-1652).

        ``los_axis3=True`` marks axis 3 (FITS counting) as the uncollapsed
        line-of-sight axis of a ``collapse=False`` product — a LINEAR axis
        in au, with the frequency axis (if any) as axis 4."""
        if image_type not in ('flux', 'tau', 'em', 'intensity'):
            raise ValueError("arg image_type must be one of 'flux', 'tau' "
                             "or 'em'")
        ra_deg = astro.parse_ra(self.params['target']['ra'])
        dec_deg = astro.parse_dec(self.params['target']['dec'])
        csize_deg = np.degrees(np.arctan(
            self.csize * cnsts.AU /
            (self.params['target']['dist'] * cnsts.PARSEC)))

        ndims = np.ndim(data)
        if ndims not in (2, 3) and not (ndims == 4 and los_axis3):
            raise ValueError(f"Unexpected number of data dimensions "
                             f"({ndims})")

        hdr = fitsio.Header()
        hdr['AUTHOR'] = 'rajepy_tpu_torch'
        hdr['OBJECT'] = self.params['target']['name']
        hdr['CTYPE1'] = 'RA---TAN'
        hdr.comments['CTYPE1'] = 'x-coord type is RA Tan Gnomonic projection'
        hdr['CTYPE2'] = 'DEC--TAN'
        hdr.comments['CTYPE2'] = 'y-coord type is DEC Tan Gnomonic projection'
        hdr['EQUINOX'] = 2000.0
        hdr.comments['EQUINOX'] = 'Equinox of coordinates'
        hdr['CRPIX1'] = self.nx / 2 + 0.5
        hdr.comments['CRPIX1'] = 'Reference pixel in RA'
        hdr['CRPIX2'] = self.nz / 2 + 0.5
        hdr.comments['CRPIX2'] = 'Reference pixel in DEC'
        hdr['CRVAL1'] = ra_deg
        hdr.comments['CRVAL1'] = 'Reference pixel value in RA (deg)'
        hdr['CRVAL2'] = dec_deg
        hdr.comments['CRVAL2'] = 'Reference pixel value in DEC (deg)'
        hdr['CDELT1'] = -csize_deg
        hdr.comments['CDELT1'] = 'Pixel increment in RA (deg)'
        hdr['CDELT2'] = csize_deg
        hdr.comments['CDELT2'] = 'Pixel size in DEC (deg)'

        if los_axis3 and ndims >= 3:
            # uncollapsed line-of-sight axis (collapse=False products)
            n_y = np.shape(data)[-3]
            hdr['CTYPE3'] = 'LINEAR'
            hdr.comments['CTYPE3'] = 'Line-of-sight axis (uncollapsed)'
            hdr['CRPIX3'] = n_y / 2.0 + 0.5
            hdr.comments['CRPIX3'] = 'Reference pixel along the LOS'
            hdr['CRVAL3'] = 0.0
            hdr.comments['CRVAL3'] = 'LOS distance at reference pixel (au)'
            hdr['CDELT3'] = float(self.csize)
            hdr.comments['CDELT3'] = 'LOS pixel increment (au)'

        def _freq_axis(n: str):
            """The reference's spectral-axis cards (classes.py:1617-1639),
            with CRVAL the frequency AT the reference pixel CRPIX."""
            fr = np.atleast_1d(np.asarray(freq, dtype=float))
            nchan = len(fr)
            chan_width = fr[1] - fr[0] if nchan != 1 else 1.0
            hdr[f'CTYPE{n}'] = 'FREQ'
            hdr.comments[f'CTYPE{n}'] = 'Spectral axis (frequency)'
            hdr[f'CRPIX{n}'] = nchan / 2.0 + 0.5
            hdr.comments[f'CRPIX{n}'] = \
                'Reference frequency (channel number)'
            hdr[f'CRVAL{n}'] = float(fr[0] + (nchan - 1) / 2.0 * chan_width)
            hdr.comments[f'CRVAL{n}'] = 'Reference frequency (Hz)'
            hdr[f'CDELT{n}'] = float(chan_width)
            hdr.comments[f'CDELT{n}'] = 'Frequency increment (Hz)'

        if image_type in ('flux', 'tau', 'intensity'):
            if ndims == 4:
                _freq_axis('4')
            elif ndims == 3 and not los_axis3:
                _freq_axis('3')
            elif ndims == 3:
                # scalar-frequency LOS cube: record the image frequency
                # without usurping the LOS axis-3 cards above
                fr = np.atleast_1d(np.asarray(freq, dtype=float))
                hdr['RESTFRQ'] = float(fr[0])
                hdr.comments['RESTFRQ'] = 'Image frequency (Hz)'
            else:
                freq_arr = np.atleast_1d(np.asarray(freq, dtype=float))
                hdr['CDELT3'] = 1.0
                hdr.comments['CDELT3'] = 'Frequency increment (Hz)'
                hdr['CRPIX3'] = 0.5
                hdr.comments['CRPIX3'] = \
                    'Reference frequency (channel number)'
                hdr['CRVAL3'] = float(freq_arr[0])
                hdr.comments['CRVAL3'] = 'Reference frequency (Hz)'

        hdr['BUNIT'] = {'flux': 'Jy pixel^-1',
                        'intensity': 'W m^-2 Hz^-1 sr^-1',
                        'em': 'pc cm^-6',
                        'tau': 'dimensionless'}[image_type]

        for line in str(self).split('\n'):
            hdr['HISTORY'] = line

        fitsio.write_fits(filename, np.nan_to_num(np.asarray(data), nan=0.0),
                          hdr, overwrite=True)

    # ------------------------------------------------------------------ #
    # Persistence (classes.py:1704-1713)
    # ------------------------------------------------------------------ #
    def _save_signature(self, with_fields: bool) -> str:
        """Fingerprint of everything :meth:`save` would write: the params
        tree (array bytes included — repr truncates), model time, and
        whether the fill-factor/area caches are part of the payload."""
        h = hashlib.blake2b(digest_size=16)

        def feed(obj):
            if isinstance(obj, dict):
                for k in sorted(obj, key=str):
                    h.update(repr(k).encode())
                    feed(obj[k])
            elif isinstance(obj, (list, tuple)):
                h.update(b'[')
                for v in obj:
                    feed(v)
            elif isinstance(obj, np.ndarray):
                h.update(repr((obj.shape, str(obj.dtype))).encode())
                h.update(np.ascontiguousarray(obj).tobytes())
            else:
                h.update(repr(obj).encode())

        feed(self._params)
        h.update(repr((float(self.time), bool(with_fields),
                       str(self._dtype))).encode())
        return h.hexdigest()

    def save(self, filename: str):
        """Pickle params + fill-factor/area caches + model time
        (classes.py:1704-1713), in the JAX package's layout
        ``{params, areas, ffs, time, log: None}`` so either package loads
        the other's checkpoints.  Written atomically.

        The fill-factor/area host copies do not change once the fields
        exist and are kept after the first pull.  An up-to-date checkpoint
        (same content signature, recorded in a ``<filename>.sig`` sidecar
        beside the pickle's byte size) is left untouched: a pipeline saves
        after every run, and the two cubes are seconds of disk at 512^3."""
        f = self._fields
        sig = self._save_signature(with_fields=f is not None)
        sig_file = filename + '.sig'
        if os.path.exists(filename) and os.path.exists(sig_file):
            try:
                with open(sig_file, 'rt') as fh:
                    old_sig, old_size = fh.read().split()
                unchanged = (old_sig == sig and
                             int(old_size) == os.path.getsize(filename))
            except (ValueError, OSError):
                unchanged = False
            if unchanged:
                self.log.add_entry(
                    "INFO", f"Model checkpoint {filename} is up to date, "
                            "not rewriting")
                return
        if f is not None and self._host_ff_cache is None:
            self._host_ff_cache = (self.areas, self.fill_factor)
        areas, ffs = self._host_ff_cache if f is not None else (None, None)
        ps = {'params': self._params,
              'areas': areas,
              'ffs': ffs,
              'time': self.time,
              'log': None}
        self.log.add_entry("INFO", f"Saving physical model to {filename}")
        with miscf.atomic_write(filename) as fh:
            pickle.dump(ps, fh)
        with miscf.atomic_write(sig_file, mode='wt') as fh:
            fh.write(f"{sig} {os.path.getsize(filename)}")

    # ------------------------------------------------------------------ #
    def __str__(self) -> str:
        """Tabulated summary (classes.py:268-361)."""
        p = self.params
        rows = [
            ('epsilon', format(p['geometry']['epsilon'], '+.3f')),
            ('opang', format(p['geometry']['opang'], '+.0f') + ' deg'),
            ('q_v', format(p['power_laws']['q_v'], '+.3f')),
            ('q_T', format(p['power_laws']['q_T'], '+.3f')),
            ('q_x', format(p['power_laws']['q_x'], '+.3f')),
            ('q_n', format(p['power_laws']['q_n'], '+.3f')),
            ('q^d_v', format(p['power_laws']['q^d_v'], '+.3f')),
            ('q^d_T', format(p['power_laws']['q^d_T'], '+.3f')),
            ('q^d_x', format(p['power_laws']['q^d_x'], '+.3f')),
            ('q^d_n', format(p['power_laws']['q^d_n'], '+.3f')),
            ('q_tau', format(p['power_laws']['q_tau'], '+.3f')),
            ('cell', format(p['grid']['c_size'], '.1f') + ' au'),
            ('w_0', format(p['geometry']['w_0'], '.2f') + ' au'),
            ('r_0', format(p['geometry']['r_0'], '.2f') + ' au'),
            ('v_0', format(p['properties']['v_0'], '.0f') + ' km/s'),
            ('x_0', format(p['properties']['x_0'], '.3f')),
            ('n_0', format(p['properties']['n_0'], '.3e') + ' cm^-3'),
            ('T_0', format(p['properties']['T_0'], '.0e') + ' K'),
            ('f_R2B', format(self._ss_jml_rb_frac, '.2e')),
            ('i', format(p['geometry']['inc'], '+.1f') + ' deg'),
            ('theta', format(p['geometry']['pa'], '+.1f') + ' deg'),
            ('D', format(p['target']['dist'], '+.0f') + ' pc'),
            ('M*', format(p['target']['M_star'], '+.1f') + ' Msol'),
            ('R_1', format(p['target']['R_1'], '+.1f') + ' au'),
            ('R_2', format(p['target']['R_2'], '+.1f') + ' au'),
        ]
        t0s = np.atleast_1d(np.asarray(p['ejection']['t_0'], dtype=float))
        if len(t0s) > 0:
            rows.append(('t_now',
                         format(self.time / cnsts.YEAR, '+.3f') + ' yr'))

        w1 = max(len(r[0]) for r in rows + [('Parameter', '')]) + 2
        w2 = max(len(r[1]) for r in rows + [('', 'Value')]) + 2
        width = w1 + w2 + 3
        hline = width * '-'
        out = [hline, '/' + format('JET MODEL', '^' + str(width - 2)) + '/',
               hline,
               '|' + format('Parameter', '^' + str(w1)) + '|' +
               format('Value', '^' + str(w2)) + '|', hline]
        for key, val in rows:
            out.append('|' + format(key, '^' + str(w1)) + '|' +
                       format(val, '^' + str(w2)) + '|')
        out.append(hline)
        out.append('/' + format('BURSTS', '^' + str(width - 2)) + '/')
        out.append(hline)
        if len(t0s) == 0:
            out.append('|' + format(' None ', '-^' + str(width - 2)) + '|')
            out.append(hline)
            return '\n'.join(out) + '\n'
        cw = (width - 4) // 3
        cws = [cw + (1 if (width - 4) % 3 > i else 0) for i in range(3)]
        for hdr_row in (('t_0', 'FWHM', 'chi'), ('[yr]', '[yr]', '')):
            out.append('|' + '|'.join(
                format(h, '^' + str(cws[i]))
                for i, h in enumerate(hdr_row)) + '|')
        out.append(hline)
        hls = np.atleast_1d(np.asarray(p['ejection']['hl'], dtype=float))
        chis = np.atleast_1d(np.asarray(p['ejection']['chi'], dtype=float))
        for i, t0 in enumerate(t0s):
            vals = (format(t0, '.2f'), format(hls[i], '.2f'),
                    format(chis[i], '.2f'))
            out.append('|' + '|'.join(
                format(v, '^' + str(cws[j]))
                for j, v in enumerate(vals)) + '|')
        out.append(hline)
        return '\n'.join(out) + '\n'
