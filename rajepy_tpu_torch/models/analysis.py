"""Derived science products: SEDs, spectral-index and turnover maps, light
curves and moment maps (PyTorch port of rajepy_tpu.models.analysis).

The continuum factorisation of :mod:`..ops.radtrans` makes the frequency
axis nearly free — one LOS reduction serves every channel — so the map
products are thin wrappers over the model's ``flux_ff`` and
``optical_depth_ff`` (on a float32 model with bursts, one launch of the
single-base epoch kernel each).  ``sed_spectral_indices`` and
``moment_maps`` work on host arrays, as in the JAX module.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import constants as cnsts
from ..ops import radtrans as rt


def sed(model, freqs) -> np.ndarray:
    """Spatially integrated free-free SED S_nu [Jy] over ``freqs`` [Hz]."""
    fluxes = model.flux_ff(np.atleast_1d(np.asarray(freqs, dtype=float)))
    return np.nansum(fluxes, axis=(1, 2))


def spectral_index_map(model, freq_lo: float, freq_hi: float,
                       min_flux_jy: float = 0.0) -> np.ndarray:
    """Two-point spectral-index map alpha = dlog S / dlog nu between two
    frequencies; NaN where either flux is at/below ``min_flux_jy``."""
    fluxes = model.flux_ff(np.asarray([freq_lo, freq_hi], dtype=float))
    lo, hi = fluxes[0], fluxes[1]
    with np.errstate(divide='ignore', invalid='ignore'):
        alpha = (np.log10(hi) - np.log10(lo)) / \
            (np.log10(freq_hi) - np.log10(freq_lo))
    return np.where((lo > min_flux_jy) & (hi > min_flux_jy), alpha, np.nan)


def sed_spectral_indices(freqs, seds) -> Tuple[np.ndarray, np.ndarray]:
    """Neighbouring-frequency spectral indices of an integrated SED and the
    log-mean frequencies they apply at (classes.py:2876+ / sed_plot)."""
    freqs = np.asarray(freqs, dtype=float)
    seds = np.asarray(seds, dtype=float)
    alphas = np.diff(np.log10(seds)) / np.diff(np.log10(freqs))
    fmid = 10 ** (0.5 * (np.log10(freqs[1:]) + np.log10(freqs[:-1])))
    return fmid, alphas


def light_curve(model, times_yr, freqs) -> np.ndarray:
    """Multi-epoch continuum light curve: integrated flux [Jy] of shape
    (n_times, n_chan) — BASELINE config 2.

    The only time-dependent factor in the RT chain is the ejection burst
    factor chi(t - travel_time) modulating the density
    (classes.py:861-899), so the static fields and the RT statics are
    computed once and each epoch re-evaluates just the LOS-collapsed
    opacity map (``JetModel._epoch_base_map``: on a float32 model with
    bursts one launch of the single-base epoch kernel, elsewhere the plain
    sum), the channel stage and the sum over the map.  The epochs' sums
    stay on the device and leave it in one copy at the end.
    """
    return epoch_flux_sums(model, times_yr, freqs).cpu().numpy()


def epoch_flux_sums(model, times_yr, freqs) -> torch.Tensor:
    """The body of :func:`light_curve`: the (n_times, n_chan) integrated
    fluxes [Jy] as a tensor on the model's device (what each shard of
    ``parallel.sharding.light_curve_sharded`` runs on its epochs)."""
    f = model._ensure_fields()
    st = model._rt_static()
    t_0, reyn, csize, dist = model._rt_constants()
    freqs = model._freqs(freqs)
    scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)[:, None, None]
    sums = []
    for t_yr in np.atleast_1d(np.asarray(times_yr, dtype=float)):
        a_map = model._epoch_base_map('a', f, st, float(t_yr) * cnsts.YEAR)
        fluxes = rt.flux_ff_maps(freqs, scale * a_map[None], st.tbar,
                                 st.any_in, csize, dist)
        sums.append(fluxes.sum(dim=(1, 2)))
    return torch.stack(sums)


def moment_maps(cube, freqs, rest_freq: float) -> dict:
    """Velocity moment maps of an RRL cube.

    ``cube`` is (n_chan, nx, nz) — flux or optical depth; channel
    velocities come from the Doppler relation v = c (1 - nu/nu0).
    Returns {'mom0', 'mom1', 'mom2'}: integrated intensity
    [cube-units * km/s], intensity-weighted velocity [km/s] and velocity
    dispersion [km/s].
    """
    cube = np.asarray(cube, dtype=float)
    freqs = np.asarray(freqs, dtype=float)
    if freqs.size < 2:
        raise ValueError("moment_maps needs >= 2 channels to define a "
                         f"velocity axis (got {freqs.size})")
    v = 299792.458 * (1.0 - freqs / rest_freq)   # km/s
    dv = np.gradient(v)
    w = cube * np.abs(dv)[:, None, None]
    mom0 = w.sum(axis=0)
    safe = np.where(mom0 > 0, mom0, 1.0)
    mom1 = (w * v[:, None, None]).sum(axis=0) / safe
    mom2 = np.sqrt(np.maximum(
        (w * (v[:, None, None] - mom1[None]) ** 2).sum(axis=0) / safe,
        0.0))
    nanmask = mom0 <= 0
    mom1 = np.where(nanmask, np.nan, mom1)
    mom2 = np.where(nanmask, np.nan, mom2)
    return {'mom0': mom0, 'mom1': mom1, 'mom2': mom2}


def turnover_map(model, freqs, tau_unity: float = 1.0) -> np.ndarray:
    """Turnover-frequency map: the frequency at which the line-of-sight
    free-free optical depth crosses ``tau_unity`` per pixel.

    Uses the factorised opacity: tau(nu) = tau_base * s(nu) with s a known
    monotone decreasing function of frequency, so the crossing can be
    solved per pixel by log interpolation over the sampled ``freqs``
    rather than a search.  Pixels never optically thick return NaN;
    always-thick pixels return the highest sampled frequency.
    """
    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    taus = model.optical_depth_ff(freqs)  # (n_chan, nx, nz)
    log_nu = np.log10(freqs)
    out = np.full(taus.shape[1:], np.nan)

    thick_any = taus[0] > tau_unity           # thickest at lowest nu
    always_thick = taus[-1] > tau_unity
    # per-pixel crossing via interpolation of log tau vs log nu
    with np.errstate(divide='ignore'):
        log_tau = np.where(taus > 0,
                           np.log10(np.maximum(taus, 1e-300)), -np.inf)
    for i in range(len(freqs) - 1):
        lo, hi = log_tau[i], log_tau[i + 1]
        crossing = (taus[i] > tau_unity) & (taus[i + 1] <= tau_unity)
        with np.errstate(divide='ignore', invalid='ignore'):
            frac = (np.log10(tau_unity) - lo) / (hi - lo)
        nu_c = 10 ** (log_nu[i] + frac * (log_nu[i + 1] - log_nu[i]))
        out = np.where(crossing & np.isnan(out), nu_c, out)
    out = np.where(always_thick, freqs[-1], out)
    out = np.where(~thick_any, np.nan, out)
    return out
