"""Joint multi-observable fitting: one theta against several observables
at once (the JAX package's ``fit/__init__.py:1262-1432``)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ._params import _check_mesh, _split_nonlte
from .driver import (FitResult, _power_norm_loss, _run_fit, _sed_loss)
from .forwards import build_flux_forward, build_sed_forward
from .rrl import build_rrl_forward, build_rrl_spectrum_forward
from .uv import _closure_loss, _vis_loss, build_vis_forward


def _component_forward_loss(jm, comp: Dict, free, time, dtype):
    """(forward, weighted_loss, theta0) for one fit_joint component.

    ``nonlte.*`` pseudo-parameters only exist in the RRL forwards; any
    other kind builds on the real-parameter subset and its forward ignores
    (zero gradient) the nonlte theta entries — departure coefficients do
    not touch the continuum, which is what lets a joint SED + non-LTE
    profile fit break the b_n1/b_n2 single-profile degeneracy.  Such a
    component's theta0 carries NaN at the nonlte slots; fit_joint merges
    slot-wise.
    """
    kind = comp['kind']
    w = float(comp.get('weight', 1.0))
    errors = comp.get('errors')
    dev = jm.device
    rrl_kinds = ('rrl_spectrum', 'rrl_cube')
    real_free, real_idx_l, nl_idx = _split_nonlte(free)
    if nl_idx and kind not in rrl_kinds:
        real_idx = torch.as_tensor(real_idx_l, dtype=torch.long,
                                   device=dev)
        fwd_r, loss_r, th0_r = _component_forward_loss(
            jm, comp, real_free, time, dtype)

        def fwd_full(theta, _f=fwd_r, _i=real_idx):
            return _f(torch.as_tensor(theta, device=dev)[_i])

        th0 = np.full(len(free), np.nan)
        th0[real_idx_l] = th0_r.cpu().numpy()
        return fwd_full, loss_r, torch.as_tensor(th0, device=dev)
    if kind == 'sed':
        fwd, th0 = build_sed_forward(jm, comp['freqs'], free, time, dtype)
        base = _sed_loss(comp['observed'], errors, dev)
    elif kind == 'map':
        fwd0, th0 = build_flux_forward(jm, np.atleast_1d(comp['freq']),
                                       free, time, dtype)

        def fwd(theta, _f=fwd0):
            return _f(theta)[0]

        base = _power_norm_loss(comp['observed'], errors, dev)
    elif kind == 'rrl_spectrum':
        fwd, th0 = build_rrl_spectrum_forward(
            jm, comp['line'], comp['freqs'], free, time, dtype,
            comp.get('contsub', True), lte=comp.get('lte', True),
            departure_coeffs=comp.get('departure_coeffs'))
        base = _power_norm_loss(comp['observed'], errors, dev)
    elif kind == 'rrl_cube':
        fwd, th0 = build_rrl_forward(
            jm, comp['line'], comp['freqs'], free, time, dtype,
            comp.get('contsub', True), lte=comp.get('lte', True),
            departure_coeffs=comp.get('departure_coeffs'))
        base = _power_norm_loss(comp['observed'], errors, dev)
    elif kind == 'visibilities':
        fwd, th0 = build_vis_forward(
            jm, comp['freqs'], comp['uvw_m'], free, time,
            comp.get('apply_pb', False),
            comp.get('dish_diameter_m', 25.0),
            comp.get('w_planes', 0))
        base = _vis_loss(comp['observed'], comp.get('sigma'), dev)
    elif kind == 'closures':
        # gain-robust structure constraint: closure observables of
        # uncalibrated visibilities (combine with an 'sed' component to
        # pin the absolute flux scale closures cannot see)
        fwd, th0 = build_vis_forward(
            jm, comp['freqs'], comp['uvw_m'], free, time,
            comp.get('apply_pb', False),
            comp.get('dish_diameter_m', 25.0),
            comp.get('w_planes', 0))
        base = _closure_loss(
            comp['observed'], comp['n_ant'], comp['n_t'],
            comp.get('use_phases', True), comp.get('use_log_amps', True),
            comp.get('phase_weight', 1.0), comp.get('amp_weight', 1.0),
            device=dev)
    else:
        raise ValueError(
            f"unknown joint-fit component kind {kind!r}; supported: "
            "sed / map / rrl_spectrum / rrl_cube / visibilities / "
            "closures")

    def loss(model, _b=base, _w=w):
        return _w * _b(model)

    return fwd, loss, th0


def fit_joint(jm, components: Sequence[Dict], *,
              free: Sequence[str] = ('properties.mlr_bj',
                                     'properties.T_0'),
              steps: int = 400, learning_rate: float = 0.05, time=None,
              dtype=None, optimizer=None, n_starts: int = 1,
              start_spread: float = 0.3, seed: int = 0,
              mesh=None) -> FitResult:
    """Fit one parameter vector against SEVERAL observables at once —
    the total loss is the (weighted) sum of each component's native loss,
    and the exact gradient flows through all of them.

    ``components`` is a sequence of dicts; each has a ``kind`` plus that
    kind's data (all accept ``errors``, ``weight`` and a per-component
    ``time`` [s] overriding the fit-level epoch, so observations of
    different epochs fit one parameter vector jointly):

    * ``{'kind': 'sed', 'freqs', 'observed'}`` — integrated fluxes [Jy]
    * ``{'kind': 'map', 'freq', 'observed'}`` — a flux map [Jy/pixel]
    * ``{'kind': 'rrl_spectrum', 'line', 'freqs', 'observed'
        [, 'contsub']}`` — an RRL line profile
    * ``{'kind': 'rrl_cube', 'line', 'freqs', 'observed'
        [, 'contsub']}`` — a resolved RRL channel cube
    * ``{'kind': 'visibilities', 'freqs', 'uvw_m', 'observed'
        [, 'sigma', 'apply_pb', 'dish_diameter_m', 'w_planes']}`` —
      complex visibilities (float64; see build_vis_forward)
    * ``{'kind': 'closures', 'freqs', 'uvw_m', 'observed', 'n_ant',
        'n_t' [, 'use_phases', 'use_log_amps', 'phase_weight',
        'amp_weight', 'apply_pb', 'dish_diameter_m', 'w_planes']}`` —
      closure phases / log closure amplitudes of uncalibrated
      visibilities (see fit_closures)

    ``dtype`` is the compute precision of the image-plane forwards
    (``torch.float32`` is the card's fitting precision).
    ``FitResult.model`` is the tuple of fitted model outputs, one per
    component.
    """
    _check_mesh(mesh)
    if not components:
        raise ValueError("fit_joint needs at least one component")

    def build(model):
        fwds, losses = [], []
        theta0 = None
        for comp in components:
            f, l, th0 = _component_forward_loss(model, comp, free,
                                                comp.get('time', time),
                                                dtype)
            fwds.append(f)
            losses.append(l)
            # slot-wise merge: a non-RRL component leaves NaN at any
            # nonlte.* slots (it has no opinion on their starting values);
            # an RRL component fills them
            th0 = th0.cpu().numpy()
            theta0 = th0 if theta0 is None else np.where(
                np.isnan(theta0), th0, theta0)
        if theta0 is not None and np.isnan(theta0).any():
            raise ValueError(
                "freed nonlte.* parameters need at least one rrl_spectrum/"
                "rrl_cube component to define their starting values")

        def forward(theta):
            return tuple(f(theta) for f in fwds)

        def loss(models):
            total = losses[0](models[0])
            for l, m in zip(losses[1:], models[1:]):
                total = total + l(m)
            return total

        return forward, torch.as_tensor(theta0, device=model.device), loss

    return _run_fit(build, jm, free, steps, learning_rate, optimizer,
                    n_starts, start_spread, seed, mesh)
