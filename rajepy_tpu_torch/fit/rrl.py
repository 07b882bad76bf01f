"""Radio-recombination-line fitting: the RRL forward (LTE and non-LTE),
the line-profile and channel-cube fits, and the departure-table
systematic (the JAX package's ``fit/__init__.py:963-1259``)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..ops import radtrans as rt
from ._params import (_NONLTE_FREE, SUPPORTED_FREE, _as_theta, _check_free,
                      _check_mesh, _encode, _gaunt_branch, _jet_cells,
                      _los_maps, _split_nonlte)
from .driver import FitResult, _power_norm_loss, _run_fit
from .forwards import _Setup
from .uncertainty import _jacobian, _theta64


def _tau_rrl_jet(coeffs, freqs, f, n_es, ds, remat, shape):
    """``radtrans.tau_rrl_maps`` evaluated on the jet cells only: the
    line opacity is zero outside the jet, so the channel loop runs over
    the gathered cells (each cell its own line of sight) and each
    channel's opacities are summed along y by :func:`_los_maps`.  The
    maps are the full-grid ones; the work and the remat checkpoints
    shrink with the jet's share of the grid."""
    cells = _jet_cells(f.inside)

    def gather(t):
        return t.reshape(-1)[cells][:, None, None]

    tau = rt.tau_rrl_maps(coeffs, freqs, gather(f.temp), gather(n_es),
                          gather(f.vy), gather(ds), gather(f.inside),
                          remat=remat)                  # (n_chan, n, 1)
    return torch.stack([_los_maps(t[:, 0], cells, shape) for t in tau])


def build_rrl_forward(jm, line: str, freqs, free: Sequence[str],
                      time: float = None, dtype=None,
                      contsub: bool = True, remat: bool = True,
                      lte: bool = True, departure_coeffs=None):
    """``(forward, theta0)`` with ``forward(theta) -> (n_chan, nx, nz)``
    RRL flux maps [Jy/pixel], differentiable in every freed parameter.

    Replays the public ``flux_rrl`` chain from first principles: grid
    fill, free-free opacity (the continuum attenuating the line),
    Doppler-shifted rest frequency, thermal + Stark widths, Voigt profile,
    kappa_L (G&S 2.114), slab intensity, flux.  ``contsub=True`` (the
    ``flux_rrl`` default) returns line-only fluxes; ``False`` adds the
    continuum.  The Doppler width constrains ``properties.T_0``, the Stark
    width and line opacity ``properties.mlr_bj``/``x_0``, the centroid and
    asymmetry the velocity field (``target.v_lsr``, ``properties.v_0``,
    ``power_laws.q_v``).  ``remat`` (default on) checkpoints the
    per-channel opacity, so the backward pass recomputes it instead of
    keeping grid-shaped temporaries per channel.  ``lte=False``, or
    freeing ``nonlte.b_n1``/``nonlte.b_n2``, takes the G&S non-LTE
    composition with the table's (or ``departure_coeffs``': scalars or
    (nx, nz) sightline maps) coefficients for those not freed.
    """
    free = tuple(free)
    _check_free(free, allow_nonlte=True)
    real_free, real_idx, nl_idx = _split_nonlte(free)
    nonlte = (not lte) or bool(nl_idx)
    if nonlte:
        if departure_coeffs is not None:
            b1_fix, b2_fix = (np.asarray(departure_coeffs[0], float),
                              np.asarray(departure_coeffs[1], float))
            if b1_fix.ndim == 0:
                b1_fix = float(b1_fix)
            if b2_fix.ndim == 0:
                b2_fix = float(b2_fix)
            for pth, bv in (('nonlte.b_n1', b1_fix),
                            ('nonlte.b_n2', b2_fix)):
                if np.ndim(bv) and np.shape(bv) != (jm.nx, jm.nz):
                    # a mis-shaped array could broadcast silently into
                    # wrong physics against the (n_chan, nx, nz) maps
                    raise ValueError(
                        f"{pth} departure coefficient must be a scalar "
                        f"or an (nx, nz) = ({jm.nx}, {jm.nz}) sightline "
                        f"map (got shape {np.shape(bv)})")
                if pth in nl_idx and np.ndim(bv):
                    raise ValueError(
                        f"freeing {pth} fits a SCALAR coefficient; its "
                        "starting value in departure_coeffs must be a "
                        "scalar (a map is only valid for a coefficient "
                        "held fixed)")
        else:
            b1_fix, b2_fix = jm.departure_coefficients(line)
    s = _Setup(jm, real_free, time, dtype)
    freqs = s.freqs(freqs)
    reyn = _gaunt_branch(s.params, free)
    coeffs = rt.RRLCoeffs(line)
    if nonlte:
        b_fixed = tuple(torch.as_tensor(np.asarray(b, np.float64),
                                        device=s.device).to(s.dt)
                        for b in (b1_fix, b2_fix))
    real_sel = torch.as_tensor(real_idx, dtype=torch.long, device=s.device)

    def forward(theta):
        theta = _as_theta(theta, s.dt, s.device)
        q, f, n_es, ds = s.fields(real_free, theta[real_sel])
        tau_c = rt.tau_ff_maps(freqs, f.temp, n_es, ds, f.inside,
                               q['properties']['T_0'], reyn)
        tau_l = _tau_rrl_jet(coeffs, freqs, f, n_es, ds, remat, s.shape)
        tbar, any_in = rt.mean_temperature_map(f.temp, f.inside)
        if nonlte:
            b1, b2 = (torch.exp(theta[nl_idx[p]]) if p in nl_idx else b
                      for p, b in zip(_NONLTE_FREE, b_fixed))
            ints = rt.intensity_rrl_maps_nonlte(freqs, tbar, tau_c, tau_l,
                                                any_in, b1, b2)
        else:
            ints = rt.intensity_rrl_maps(freqs, tbar, tau_c, tau_l, any_in)
        fl = ints * rt.flux_scale_jy(s.csize, q['target']['dist'])
        if not contsub:
            fl = fl + rt.flux_ff_maps(freqs, tau_c, tbar, any_in, s.csize,
                                      q['target']['dist'])
        return fl

    th0 = torch.zeros(len(free), dtype=torch.float64, device=s.device)
    th0[real_idx] = _encode(real_free, s.params, s.device)
    for pth, i in nl_idx.items():
        th0[i] = float(np.log(b1_fix if pth == 'nonlte.b_n1' else b2_fix))
    return forward, th0


def build_rrl_spectrum_forward(jm, line: str, freqs, free: Sequence[str],
                               time: float = None, dtype=None,
                               contsub: bool = True, lte: bool = True,
                               departure_coeffs=None):
    """``forward(theta) -> (n_chan,)`` spatially-integrated RRL spectrum
    [Jy] — the line profile a single-dish or unresolved-interferometric
    observation measures.  ``lte=False`` (or freeing the ``nonlte.*``
    pseudo-parameters) swaps in the G&S non-LTE composition."""
    fwd, theta0 = build_rrl_forward(jm, line, freqs, free, time, dtype,
                                    contsub, lte=lte,
                                    departure_coeffs=departure_coeffs)

    def forward(theta):
        return torch.sum(fwd(theta), dim=(1, 2))

    return forward, theta0


def fit_rrl_spectrum(jm, line: str, freqs, observed, *, errors=None,
                     free: Sequence[str] = ('properties.T_0',
                                            'target.v_lsr'),
                     steps: int = 400, learning_rate: float = 0.05,
                     time=None, contsub: bool = True,
                     optimizer=None, n_starts: int = 1,
                     start_spread: float = 0.3, seed: int = 0,
                     mesh=None, lte: bool = True,
                     departure_coeffs=None) -> FitResult:
    """Fit freed parameters to an observed RRL spectrum (integrated
    fluxes [Jy] at channel frequencies ``freqs`` spanning the line), in
    float64 on the model's device.

    The default frees recover temperature from the Doppler width and
    systemic velocity from the centroid.  The loss is least squares
    normalised by the observed power (line fluxes pass through zero in
    the wings); with ``errors`` it is the per-channel chi-squared.
    ``lte=False``, or freeing ``'nonlte.b_n1'``/``'nonlte.b_n2'``, fits
    through the G&S non-LTE composition; free one coefficient at a time
    unless another observable pins the other.  With table-derived
    coefficients the statistical sigmas miss the table's rate systematic:
    add :func:`rrl_departure_systematic` in quadrature.
    """
    _check_mesh(mesh)

    def build(model):
        forward, theta0 = build_rrl_spectrum_forward(
            model, line, freqs, free, time, contsub=contsub, lte=lte,
            departure_coeffs=departure_coeffs)
        return forward, theta0, _power_norm_loss(observed, errors,
                                                 theta0.device)

    return _run_fit(build, jm, free, steps, learning_rate, optimizer,
                    n_starts, start_spread, seed, mesh)


def fit_rrl_cube(jm, line: str, freqs, observed_cube, *, errors=None,
                 free: Sequence[str] = ('properties.T_0',
                                        'properties.v_0'),
                 steps: int = 400, learning_rate: float = 0.05,
                 time=None, contsub: bool = True,
                 optimizer=None, n_starts: int = 1,
                 start_spread: float = 0.3, seed: int = 0,
                 mesh=None, lte: bool = True,
                 departure_coeffs=None) -> FitResult:
    """Fit freed parameters to a spatially-resolved RRL channel cube
    ``observed_cube`` of shape (n_chan, nx, nz) [Jy/pixel].

    Position-velocity structure constrains the velocity law
    (``properties.v_0``, ``power_laws.q_v``) that an integrated spectrum
    blends away.  ``lte``/``departure_coeffs``/``nonlte.*`` frees as in
    :func:`fit_rrl_spectrum`.
    """
    _check_mesh(mesh)

    def build(model):
        fwd, theta0 = build_rrl_forward(model, line, freqs, free, time,
                                        contsub=contsub, lte=lte,
                                        departure_coeffs=departure_coeffs)
        return fwd, theta0, _power_norm_loss(observed_cube, errors,
                                             theta0.device)

    return _run_fit(build, jm, free, steps, learning_rate, optimizer,
                    n_starts, start_spread, seed, mesh)


def rrl_departure_systematic(jm, line: str, freqs, theta,
                             free: Sequence[str], *, cube: bool = False,
                             time=None, contsub: bool = True
                             ) -> Dict[str, float]:
    """Systematic uncertainties on a non-LTE RRL fit's freed parameters
    from the departure-coefficient table's collisional-rate error band.

    The forward is re-evaluated at the fit optimum ``theta`` with the
    coherent 'lo'/'hi' coefficient pairs, and each model shift is mapped
    to the parameter shift that would absorb it through the
    pseudo-inverse of the forward Jacobian, dtheta = J^+ (forward_shifted
    - forward_central).  Returns ``{path: systematic sigma}`` in value
    space (delta method for log parameters); add in quadrature to the
    statistical sigmas.  Irrelevant when the fit freed the coefficients or
    was given measured ``departure_coeffs``.
    """
    free = tuple(free)
    for p in free:
        if p in _NONLTE_FREE:
            raise ValueError(
                f"{p} was a FREE parameter: the data constrained it and "
                "the table systematic does not apply — drop it from "
                "`free` here and propagate only the fixed-coefficient "
                "error")
    theta = _theta64(theta).to(jm.device)
    build = build_rrl_forward if cube else build_rrl_spectrum_forward
    b_c = jm.departure_coefficients(line)
    fwd_c, _ = build(jm, line, freqs, free, time, contsub=contsub,
                       lte=False, departure_coeffs=b_c)

    def flat(th):
        return torch.ravel(fwd_c(th))

    with torch.no_grad():
        y0 = flat(theta).cpu().numpy()
    J = _jacobian(flat, theta).cpu().numpy()
    dtheta_max = np.zeros(len(free))
    for which in ('lo', 'hi'):
        b_s = jm.departure_coefficients_at_scale(line, which)
        fwd_s, _ = build(jm, line, freqs, free, time, contsub=contsub,
                           lte=False, departure_coeffs=b_s)
        with torch.no_grad():
            dy = torch.ravel(fwd_s(theta)).cpu().numpy() - y0
        dth, *_ = np.linalg.lstsq(J, dy, rcond=None)
        dtheta_max = np.maximum(dtheta_max, np.abs(dth))
    out = {}
    theta = theta.cpu().numpy()
    for i, path in enumerate(free):
        if SUPPORTED_FREE[path] == 'log':
            out[path] = float(np.exp(theta[i])) * float(dtheta_max[i])
        else:
            out[path] = float(dtheta_max[i])
    return out
