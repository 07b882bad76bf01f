"""Visibility-space fitting: the interferometric forward, fits to
visibilities, to a UVFITS file and to closure quantities, and the closure
uncertainties (the JAX package's ``fit/__init__.py:685-960``)."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import constants as cnsts
from ..synthobs import calibration as _cal
from ..synthobs import sampler as _sampler
from ._params import _check_mesh
from .driver import FitResult, _run_fit
from .forwards import build_flux_forward
from .uncertainty import _gauss_newton_sigmas, _theta64


def build_vis_forward(jm, freqs, uvw_m, free: Sequence[str],
                      time: float = None, apply_pb: bool = False,
                      dish_diameter_m: float = 25.0,
                      w_planes: int = 0):
    """``(forward, theta0)`` with ``forward(theta) -> (n_chan, n_vis)``
    complex visibilities [Jy] at baseline coordinates ``uvw_m`` [m].

    The differentiable flux maps are transposed into the sky frame
    ((dec, ra), the FITS orientation) and Fourier-sampled by
    ``synthobs.sampler.sample_vis_cube`` (taper-corrected FFT +
    Kaiser-Bessel degrid, per channel at its own wavelength, optional
    primary beam).  Every step is differentiable, so model parameters are
    fitted directly to visibilities, with no imaging in the loop.
    ``w_planes >= 1`` routes through the w-stacked sampler (also
    differentiable).  Float64 on the model's device.
    """
    if 'target.dist' in free:
        raise ValueError(
            "'target.dist' cannot be freed in visibility space: the "
            "pixel scale is baked into the uv sampling grid (fit it "
            "against SEDs/maps instead)")
    flux_fwd, theta0 = build_flux_forward(jm, freqs, free, time)
    params = jm.params
    cell_rad = float(np.arctan(params['grid']['c_size'] * cnsts.AU /
                               (params['target']['dist'] * cnsts.PARSEC)))
    dev = jm.device
    uvw = torch.as_tensor(np.asarray(uvw_m, np.float64), device=dev)
    freqs_arr = torch.atleast_1d(torch.as_tensor(
        np.asarray(freqs, np.float64), device=dev))

    def forward(theta):
        maps = flux_fwd(theta)                      # (n_chan, nx, nz)
        sky = maps.permute(0, 2, 1)                 # (n_chan, dec, ra)
        return _sampler.sample_vis_cube(
            sky, cell_rad, uvw, freqs_arr, apply_pb=apply_pb,
            dish_diameter_m=dish_diameter_m, w_planes=w_planes,
            centre='fits')

    return forward, theta0


def _vis_loss(vis_obs, sigma, device):
    """Mean chi-squared |V_model - V_obs|^2 / sigma^2 (unit weights
    without ``sigma``)."""
    obs = torch.as_tensor(np.asarray(vis_obs, complex), device=device)
    w = 1.0 if sigma is None else 1.0 / torch.as_tensor(
        np.asarray(sigma, np.float64), device=device) ** 2

    def loss(model):
        r = model - obs
        return torch.mean((r.real ** 2 + r.imag ** 2) * w)

    return loss


def fit_visibilities(jm, freqs, uvw_m, vis_obs, *, sigma=None,
                     free: Sequence[str] = ('properties.mlr_bj',
                                            'properties.T_0'),
                     steps: int = 400, learning_rate: float = 0.05,
                     time=None, apply_pb: bool = False,
                     dish_diameter_m: float = 25.0, w_planes: int = 0,
                     optimizer=None, n_starts: int = 1,
                     start_spread: float = 0.3, seed: int = 0,
                     mesh=None) -> FitResult:
    """Fit freed parameters directly to observed complex visibilities
    (n_chan, n_vis) — no imaging in the loop.

    ``sigma`` is the per-visibility thermal noise [Jy] (scalar or
    broadcastable); the loss is the mean radio-interferometric
    chi-squared |V_model - V_obs|^2 / sigma^2 (unit weights when omitted).
    """
    _check_mesh(mesh)

    def build(model):
        forward, theta0 = build_vis_forward(model, freqs, uvw_m, free, time,
                                            apply_pb, dish_diameter_m,
                                            w_planes)
        return forward, theta0, _vis_loss(vis_obs, sigma, theta0.device)

    return _run_fit(build, jm, free, steps, learning_rate, optimizer,
                    n_starts, start_spread, seed, mesh)


def fit_uvfits(jm, uvfits_file: str, **kwargs) -> FitResult:
    """Fit freed parameters to the visibilities in a UVFITS file.

    Any random-groups UVFITS (``export_uvfits`` products, or data exported
    by CASA/AIPS) is read by :func:`rajepy_tpu_torch.synthobs.uvfits.
    read_uvfits` and handed to :func:`fit_visibilities` with the file's
    (u, v, w), channel frequencies and weights (sigma = 1/sqrt(weight);
    weights <= 0 flag visibilities out of the chi-squared).  All
    :func:`fit_visibilities` keywords pass through; an explicit ``sigma``
    overrides the file weights.

    Visibilities are assumed to follow the AIPS/memo-117 phase sign (the
    convention ``write_uvfits`` produces and CASA/AIPS exports use).  A
    conjugated file does not fail silently: with correct weights the
    converged ``FitResult.loss`` sits at the reduced-chi-squared floor
    (~1-3); a final loss far above that signals a convention mismatch.
    """
    from ..synthobs.uvfits import read_uvfits
    _check_mesh(kwargs.get('mesh'))
    d = read_uvfits(uvfits_file)
    vis = d['vis_re'] + 1j * d['vis_im']
    if kwargs.get('sigma') is None:
        w = d['weights']
        # zero weight -> zero chi-squared contribution (1/sigma^2 = 0)
        kwargs['sigma'] = np.where(
            w > 0, 1.0 / np.sqrt(np.where(w > 0, w, 1.0)), np.inf)
    return fit_visibilities(jm, d['freqs'], d['uvw'], vis, **kwargs)


def fit_closures(jm, freqs, uvw_m, vis_obs, *, n_ant: int, n_t: int,
                 free: Sequence[str] = ('properties.mlr_bj',),
                 use_phases: bool = True, use_log_amps: bool = True,
                 phase_weight: float = 1.0, amp_weight: float = 1.0,
                 steps: int = 400, learning_rate: float = 0.05,
                 time=None, apply_pb: bool = False,
                 dish_diameter_m: float = 25.0, w_planes: int = 0,
                 optimizer=None, n_starts: int = 1,
                 start_spread: float = 0.3, seed: int = 0,
                 mesh=None) -> FitResult:
    """Gain-robust uv-plane fitting: fit freed parameters to the CLOSURE
    observables of observed visibilities — closure phases (bispectrum
    phases over antenna triangles) and log closure amplitudes (quadrangle
    ratios), which antenna-based complex gains cannot corrupt.

    ``vis_obs``: (n_chan, n_t * n_bl) complex in ``simulate_observation``'s
    time-major full-antenna-pair layout (``n_bl = n_ant (n_ant - 1) /
    2``), ``uvw_m`` rows in the same order.  The closure-phase residual is
    the wrap-free ``1 - cos(phi_model - phi_data)``; the amplitude residual
    is least squares in log space.  Closures carry no absolute flux or
    position: combine with an SED component through :func:`fit_joint` to
    pin the flux scale when more than shape parameters are free.
    """
    _check_mesh(mesh)

    def build(model):
        forward, theta0 = build_vis_forward(model, freqs, uvw_m, free, time,
                                            apply_pb, dish_diameter_m,
                                            w_planes)
        return forward, theta0, _closure_loss(
            vis_obs, n_ant, n_t, use_phases, use_log_amps, phase_weight,
            amp_weight, device=model.device)

    return _run_fit(build, jm, free, steps, learning_rate, optimizer,
                    n_starts, start_spread, seed, mesh)


def _check_closure_kinds(n_ant, use_phases, use_log_amps):
    if not (use_phases or use_log_amps):
        raise ValueError("enable at least one of use_phases / "
                         "use_log_amps")
    if use_log_amps and n_ant < 4:
        raise ValueError("log closure amplitudes need n_ant >= 4 "
                         f"(got {n_ant}); use use_log_amps=False")
    if use_phases and n_ant < 3:
        raise ValueError(f"closure phases need n_ant >= 3 (got {n_ant})")


def closure_uncertainties(jm, freqs, uvw_m, vis_obs, theta,
                          free: Sequence[str], *, n_ant: int, n_t: int,
                          use_phases: bool = True,
                          use_log_amps: bool = True, time=None,
                          apply_pb: bool = False,
                          dish_diameter_m: float = 25.0,
                          w_planes: int = 0
                          ) -> Tuple[Dict[str, float], np.ndarray]:
    """Gauss-Newton 1-sigma uncertainties at a :func:`fit_closures`
    optimum (``theta`` from ``FitResult.theta``).

    Residuals are the wrap-free closure-phase differences via
    unit-bispectrum cross products (Im(B_m conj(B_d)) ~ phi_m - phi_d near
    the optimum) and the log-closure-amplitude differences.  Each block is
    whitened by its own residual RMS before the joint Jacobian (the
    block-wise ``absolute_sigma=False`` convention).  Returns ``(sigmas,
    cov)`` like :func:`laplace_uncertainties`.
    """
    _check_closure_kinds(n_ant, use_phases, use_log_amps)
    forward, _ = build_vis_forward(jm, freqs, uvw_m, free, time,
                                   apply_pb, dish_diameter_m, w_planes)
    bisp, logclamp = _closure_ops(n_ant, jm.device)
    v_d = _closure_data(vis_obs, n_ant, n_t, jm.device)
    eps = 1e-30
    b_d = bisp(v_d)
    bd_u = b_d / (torch.abs(b_d) + eps)
    la_d = logclamp(v_d)

    def blocks(th):
        v_m = forward(th).reshape(v_d.shape)
        out = []
        if use_phases:
            b_m = bisp(v_m)
            bm_u = b_m / (torch.abs(b_m) + eps)
            out.append(torch.ravel((bm_u * torch.conj(bd_u)).imag))
        if use_log_amps:
            out.append(torch.ravel(logclamp(v_m) - la_d))
        return out

    theta = _theta64(theta).to(jm.device)
    # floor the whitening scale well above underflow: exactly-zero
    # residual blocks (noiseless data at the optimum) would otherwise blow
    # the Jacobian up to inf; 1e-12 keeps J^T J finite in float64 and
    # still reports ~zero sigma for such data
    with torch.no_grad():
        scales = [max(float(torch.sqrt(torch.mean(b ** 2))), 1e-12)
                  for b in blocks(theta)]

    def resid(th):
        return torch.cat([b / s for b, s in zip(blocks(th), scales)])

    return _gauss_newton_sigmas(resid, theta, free, estimate_scale=False)


def _closure_ops(n_ant: int, device):
    """``(bisp, logclamp)`` on complex (..., n_t, n_bl) visibility
    tensors over the full triangle / quadrangle sets: the shared cores of
    :mod:`..synthobs.calibration`, so each closure is defined once."""
    idx = _cal.closure_index_arrays(n_ant, device)
    return (lambda v: _cal.bisp_core(v, *idx['tri']),
            lambda v: _cal.logclamp_core(v, *idx['quad']))


def _closure_data(vis_obs, n_ant: int, n_t: int, device):
    """Validate the layout and return the observed visibilities as a
    complex (n_chan, n_t, n_bl) tensor on ``device``."""
    obs = np.asarray(vis_obs, complex)
    if obs.ndim == 1:
        obs = obs[None]
    n_bl = n_ant * (n_ant - 1) // 2
    if obs.shape[-1] != n_t * n_bl:
        raise ValueError(
            f"vis_obs last axis {obs.shape[-1]} != n_t*n_bl "
            f"({n_t}x{n_bl}) — closure indexing needs the full "
            "time-major antenna-pair layout")
    return torch.as_tensor(obs.reshape(obs.shape[0], n_t, n_bl),
                           device=device)


def _closure_loss(vis_obs, n_ant: int, n_t: int, use_phases: bool = True,
                  use_log_amps: bool = True, phase_weight: float = 1.0,
                  amp_weight: float = 1.0, *, device):
    """``loss(model_vis)`` against the closure observables of ``vis_obs``
    (see :func:`fit_closures` for the residual forms)."""
    _check_closure_kinds(n_ant, use_phases, use_log_amps)
    bisp, logclamp = _closure_ops(n_ant, device)
    eps = 1e-30
    v_d = _closure_data(vis_obs, n_ant, n_t, device)
    b_d = bisp(v_d)
    bd_unit_conj = torch.conj(b_d) / (torch.abs(b_d) + eps)
    la_d = logclamp(v_d)

    def loss(model):
        v_m = model.reshape(v_d.shape)
        total = 0.0
        if use_phases:
            b_m = bisp(v_m)
            total += phase_weight * torch.mean(
                1.0 - (b_m * bd_unit_conj).real / (torch.abs(b_m) + eps))
        if use_log_amps:
            total += amp_weight * torch.mean((logclamp(v_m) - la_d) ** 2)
        return total

    return loss
