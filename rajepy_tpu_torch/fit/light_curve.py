"""Light-curve fitting: the ejection-burst parameters from a flux time
series (the JAX package's ``fit/__init__.py:1435-1616``)."""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..models.ejection import chi_scan
from ..ops import radtrans as rt
from ._params import YEAR, _jet_cells, _los_maps
from .driver import Adam, _descend, _f64, _sed_loss


class BurstFitResult(NamedTuple):
    """Fitted ejection-event parameters (years / chi factors, the
    params['ejection'] schema)."""
    t_0: np.ndarray            # burst peak times [yr]
    hl: np.ndarray             # half-lives [yr]
    chi: np.ndarray            # peak jml / steady-state jml
    loss: np.ndarray
    model: np.ndarray          # fitted light curve (n_times, n_chan)


def build_light_curve_forward(jm, times, freqs,
                              free: Sequence[str] = ('t_0', 'hl', 'chi')):
    """``(forward, theta0, unpack)``: light curve (n_times, n_chan) [Jy]
    as a function of the ejection-event parameters, float64 on the
    model's device.

    The static fields, the base opacity cube and the channel scale do not
    depend on the bursts, so they are computed once and closed over; only
    the burst factor is evaluated per epoch, the factorisation of the
    model's epoch path, here in plain differentiable torch.  The base
    opacity is zero outside the jet, so the per-epoch work runs on the jet
    cells alone and each epoch's map is their sum along y.  theta packs,
    per burst, [t_0/yr (linear), log hl/yr, log chi] for each freed name.
    """
    for p in free:
        if p not in ('t_0', 'hl', 'chi'):
            raise ValueError(f"free must be among t_0/hl/chi, got {p!r}")
    params = jm.params
    ej = params['ejection']
    t0_yr = np.atleast_1d(np.asarray(ej['t_0'], float))
    hl_yr = np.atleast_1d(np.asarray(ej['hl'], float))
    chi_f = np.atleast_1d(np.asarray(ej['chi'], float))
    which = [str(w).upper() for w in np.atleast_1d(np.asarray(ej['which']))]
    n_b = len(t0_yr)
    if n_b == 0:
        raise ValueError("model has no ejection events to fit")

    f = jm._ensure_fields()
    reyn = jm._use_reynolds_gaunt()
    csize, dist = params['grid']['c_size'], params['target']['dist']
    dt, dev = torch.float64, jm.device
    shape = (jm.nx, jm.ny, jm.nz)
    nd, xi, temp, ff, area = (a.to(dt) for a in
                              (f.nd, f.xi, f.temp, f.ff, f.area))
    ds = rt.path_length_cm(ff, area, csize)
    base = rt.tau_ff_base(temp, nd * xi, ds, f.inside, reyn)
    cells = _jet_cells(f.inside)
    base_c = base.reshape(-1)[cells]
    ts_c = f.ts.to(dt).reshape(-1)[cells]
    red_c = f.red.reshape(-1)[cells]
    freqs = torch.atleast_1d(_f64(freqs, dev))
    scale = rt.tau_ff_channel_scale(freqs, params['properties']['T_0'],
                                    reyn)
    tbar, any_in = rt.mean_temperature_map(temp, f.inside)
    times = _f64(np.atleast_1d(np.asarray(times, float)), dev)
    del nd, xi, temp, ff, area, ds, base

    theta0, layout = [], []
    for i in range(n_b):
        for name in free:
            layout.append((i, name))
            theta0.append({'t_0': t0_yr[i], 'hl': np.log(hl_yr[i]),
                           'chi': np.log(chi_f[i])}[name])
    theta0 = torch.as_tensor(np.asarray(theta0, np.float64), device=dev)

    def unpack(theta):
        """theta -> (t0 [s], sigma [s], chi) per burst (lists of 0-d
        tensors)."""
        t0 = [torch.tensor(t, dtype=dt, device=dev) for t in t0_yr]
        hl = [torch.tensor(h, dtype=dt, device=dev) for h in hl_yr]
        ch = [torch.tensor(c, dtype=dt, device=dev) for c in chi_f]
        for j, (i, name) in enumerate(layout):
            if name == 't_0':
                t0[i] = theta[j]
            elif name == 'hl':
                hl[i] = torch.exp(theta[j])
            else:
                ch[i] = torch.exp(theta[j])
        # sigma = hl * 2 / (2 sqrt(2 ln 2)) (ejection.py:34-36)
        sig = [h * YEAR / math.sqrt(2.0 * math.log(2.0)) for h in hl]
        return ([t * YEAR for t in t0], sig, ch)

    # burst -> jet-side assignment ('R' in which / 'B' in which)
    sides = [(('R' in w), ('B' in w)) for w in which]

    def forward(theta):
        theta = _f64(theta, dev)
        t0_s, sig_s, chi_s = unpack(theta)
        b_t0, b_sig, b_amp, b_red = [], [], [], []
        for i in range(n_b):
            for red_side in (True, False):
                if sides[i][0 if red_side else 1]:
                    b_t0.append(t0_s[i])
                    b_sig.append(sig_s[i])
                    b_amp.append(chi_s[i] - 1.0)
                    b_red.append(red_side)
        bt0, bsig, bamp = (torch.stack(b) for b in (b_t0, b_sig, b_amp))
        out = []
        for t in times:
            chi = chi_scan(red_c, t - ts_c, bt0, bsig, bamp, b_red)
            tau_map = scale[:, None, None] * \
                _los_maps(base_c * chi * chi, cells, shape)[None]
            fl = rt.flux_ff_maps(freqs, tau_map, tbar, any_in, csize, dist)
            out.append(torch.sum(fl, dim=(1, 2)))
        return torch.stack(out)

    return forward, theta0, unpack


def fit_light_curve(jm, times, freqs, observed, *, errors=None,
                    free: Sequence[str] = ('t_0', 'hl', 'chi'),
                    steps: int = 500, learning_rate: float = 0.05,
                    optimizer=None) -> BurstFitResult:
    """Recover ejection-event parameters from an observed flux time
    series: ``observed`` is (n_times,) or (n_times, n_chan) fluxes [Jy]
    at model times ``times`` [s].  ``optimizer`` is None (Adam) or a
    callable ``params -> torch.optim.Optimizer``."""
    forward, theta0, unpack = build_light_curve_forward(jm, times, freqs,
                                                        free)
    obs = np.atleast_1d(np.asarray(observed, float))
    if obs.ndim == 1:
        obs = obs[:, None]
        if errors is not None:
            # match the observed reshape: 1-D per-time errors against the
            # (n_times, 1) observations would broadcast the residual to an
            # (n_times, n_times) outer difference (2-D observed keeps
            # errors as given: an (n_chan,) vector broadcasts per channel)
            errors = np.atleast_1d(np.asarray(errors, float))
            if errors.ndim == 1:
                errors = errors[:, None]
    loss = _sed_loss(obs, errors, theta0.device)
    make_opt = optimizer if optimizer is not None else (
        lambda ps: Adam(ps, lr=learning_rate))
    theta, hist, _ = _descend(lambda th: loss(forward(th)), theta0, steps,
                              make_opt)
    t0_s, sig_s, chi_s = unpack(theta)
    t0 = np.asarray([float(t) for t in t0_s]) / YEAR
    hl = np.asarray([float(s) for s in sig_s]) / YEAR * \
        np.sqrt(2.0 * np.log(2.0))
    chis = np.asarray([float(c) for c in chi_s])
    with torch.no_grad():
        model = forward(theta).cpu().numpy()
    return BurstFitResult(t_0=t0, hl=hl, chi=chis, loss=hist.cpu().numpy(),
                          model=model)
