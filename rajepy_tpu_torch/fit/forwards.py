"""The continuum forward models of a fit: flux maps and SEDs as
differentiable functions of ``theta`` (the JAX package's
``fit/__init__.py:207-279``)."""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from ..models import fields as F
from ..models.ejection import chi_scan
from ..models import grid as G
from ..ops import radtrans as rt
from ._params import (_SERIES_FREE, _as_theta, _check_free, _encode,
                      _gaunt_branch, _substitute)


def _burst_arrays(jm, dt):
    """The model's bursts as tensors for
    :func:`~rajepy_tpu_torch.models.ejection.chi_scan`: (t0 [s],
    sigma [s], relative amplitude, is_red), or None without bursts.  The
    burst shapes stay fixed in the image-plane forwards (free them with
    ``fit_light_curve``); only the steady-state rates they are relative to
    may move, and chi is a ratio, so the fixed arrays are exact."""
    if not jm._has_bursts:
        return None
    burst = jm._burst_tuple()
    dev = jm.device
    return (torch.tensor([b[0] for b in burst], dtype=dt, device=dev),
            torch.tensor([np.sqrt(1.0 / (2.0 * b[1])) for b in burst],
                         dtype=dt, device=dev),
            torch.tensor([b[2] for b in burst], dtype=dt, device=dev),
            [b[3] for b in burst])


class _Setup:
    """What every image-plane forward closes over: the params, the epoch,
    the compute dtype, the corner coordinates and the bursts."""

    def __init__(self, jm, free, time, dtype):
        self.params = copy.deepcopy(jm.params)
        self.t_model = float(jm.time if time is None else time)
        self.dt = torch.float64 if dtype is None else dtype
        self.device = jm.device
        self.shape = (jm.nx, jm.ny, jm.nz)
        self.coords = G.grid_corner_coords(
            *self.shape, self.params['grid']['c_size'], self.dt, jm.device)
        self.csize = self.params['grid']['c_size']
        self.bursts = _burst_arrays(jm, self.dt)
        self.series_paths = tuple(p for p in free if p in _SERIES_FREE)

    def freqs(self, freqs):
        return torch.atleast_1d(torch.as_tensor(
            np.asarray(freqs, np.float64), device=self.device).to(self.dt))

    def fields(self, free, theta):
        """(q, f, n_es, ds) at ``theta``: the substituted params, the grid
        fill, the burst-modulated electron density and the path lengths."""
        q, rb_frac = _substitute(free, self.params, theta)
        try:
            f = F.compute_static_fields(q, *self.coords, rb_frac,
                                        with_time=self.bursts is not None)
        except ValueError as err:
            # ops.hyp2f1 refuses a derivative through the 2F1 series
            if not self.series_paths:
                raise
            raise ValueError(f"freed {', '.join(self.series_paths)}: "
                             f"{err}") from err
        nd = f.nd
        if self.bursts is not None:
            nd = nd * chi_scan(f.red, self.t_model - f.ts, *self.bursts)
        return q, f, nd * f.xi, rt.path_length_cm(f.ff, f.area, self.csize)


def build_flux_forward(jm, freqs, free: Sequence[str],
                       time: float = None, dtype=None):
    """``(forward, theta0)`` with ``forward(theta) -> (n_chan, nx, nz)``
    flux maps [Jy/pixel], differentiable in every freed parameter.

    Replays the public ``flux_ff`` chain from first principles each call:
    grid fill (``fields.compute_static_fields``) through the factorised
    opacity (``radtrans.tau_ff_maps``), not the model's cached epoch path,
    whose statics hold the parameters as constants.  ``time`` defaults to
    the model's current epoch; bursts are included whenever the model has
    any.  ``dtype`` is the compute precision (default float64); ``theta``
    (numpy or a tensor) stays float64 outside.  Runs on the model's device.
    """
    _check_free(free)
    free = tuple(free)
    s = _Setup(jm, free, time, dtype)
    freqs = s.freqs(freqs)
    reyn = _gaunt_branch(s.params, free)

    def forward(theta):
        theta = _as_theta(theta, s.dt, s.device)
        q, f, n_es, ds = s.fields(free, theta)
        taus = rt.tau_ff_maps(freqs, f.temp, n_es, ds, f.inside,
                              q['properties']['T_0'], reyn)
        tbar, any_in = rt.mean_temperature_map(f.temp, f.inside)
        return rt.flux_ff_maps(freqs, taus, tbar, any_in, s.csize,
                               q['target']['dist'])

    return forward, _encode(free, s.params, s.device)


def build_sed_forward(jm, freqs, free: Sequence[str], time: float = None,
                      dtype=None):
    """``forward(theta) -> (n_chan,)`` integrated fluxes [Jy].

    ``dtype`` selects the compute precision of the forward (default
    float64); float32 runs the forward and its backward at the card's
    native precision, the optimisation vector staying float64 outside.
    """
    fwd, theta0 = build_flux_forward(jm, freqs, free, time, dtype)

    def forward(theta):
        return torch.sum(fwd(theta), dim=(1, 2))

    return forward, theta0
