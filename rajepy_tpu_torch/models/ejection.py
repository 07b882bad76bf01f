"""Time-dependent ejection (burst) machinery — bursts as data (PyTorch port
of rajepy_tpu.models.ejection).

Each jet's variable mass-loss rate is a static array spec:

    jml(t) = jml_ss + sum_i amp_i * exp(-(t - t0_i)^2 / (2 sigma_i^2))

with ``amp_i = peak_jml_i - jml_ss`` and ``sigma_i = half_life_i * 2 /
(2 sqrt(2 ln 2))`` exactly as the reference's classes.py:442-448.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

YEAR = 31536000.0


class EjectionSpec(NamedTuple):
    """Burst parameters for one jet (red or blue), SI units."""
    ss_jml: float           # steady-state mass-loss rate [kg/s]
    t_0: np.ndarray         # burst peak times [s]
    peak_jml: np.ndarray    # peak mass-loss rates [kg/s]
    half_life: np.ndarray   # burst half-lives [s]

    @property
    def sigma(self) -> np.ndarray:
        # classes.py:446: sigma = half_life * 2 / (2 sqrt(2 ln 2))
        return self.half_life * 2.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))

    def jml(self, t):
        """Mass-loss rate [kg/s] at time(s) ``t`` [s] (classes.py:442-448):
        a tensor for a tensor, else a float64 numpy array."""
        if isinstance(t, torch.Tensor):
            xp = torch
        else:
            t, xp = np.asarray(t, dtype=np.float64), np
        exp = xp.exp
        out = xp.zeros_like(t) + self.ss_jml
        for t0, peak, sig in zip(self.t_0, self.peak_jml, self.sigma):
            out = out + (peak - self.ss_jml) * exp(-(t - t0) ** 2 /
                                                   (2.0 * sig ** 2))
        return out

    def chi(self, t):
        """Burst factor jml(t)/jml_ss (classes.py:861-870)."""
        return self.jml(t) / self.ss_jml


def build_ejection_specs(params: Dict, ss_jml_bj: float,
                         ss_jml_rj: float) -> Tuple[EjectionSpec,
                                                    EjectionSpec]:
    """Translate the params['ejection'] arrays (years / chi factors) into
    per-jet specs, honouring the 'which' selector exactly as
    classes.py:248-264."""
    ej = params['ejection']
    t0 = np.atleast_1d(np.asarray(ej['t_0'], dtype=float)) * YEAR
    hl = np.atleast_1d(np.asarray(ej['hl'], dtype=float)) * YEAR
    chi = np.atleast_1d(np.asarray(ej['chi'], dtype=float))
    which = np.atleast_1d(np.asarray(ej['which']))

    specs = {}
    for side, ss in (('R', ss_jml_rj), ('B', ss_jml_bj)):
        sel = np.array([side in str(w).upper() for w in which], dtype=bool)
        specs[side] = EjectionSpec(
            ss_jml=ss,
            t_0=t0[sel],
            peak_jml=ss * chi[sel],
            half_life=hl[sel])
    return specs['R'], specs['B']


def chi_field(red: torch.Tensor, launch_time: torch.Tensor,
              spec_r: EjectionSpec, spec_b: EjectionSpec) -> torch.Tensor:
    """Burst factor per cell: the red spec on the red-jet side (r < 0,
    passed as a boolean mask), blue elsewhere (classes.py:861-870).
    ``launch_time`` [s] is model time minus the cell's travel time
    (classes.py:844-845).

    A loop over the stacked bursts of both jets that keeps two live grids
    (the running sum and one burst's gaussian), as the JAX version's
    ``lax.scan`` does.  The burst scalars are rounded to
    ``launch_time``'s dtype first, as the scan's stacked arrays are.
    """
    n_r, n_b = len(spec_r.t_0), len(spec_b.t_0)
    if n_r + n_b == 0:
        return torch.ones_like(launch_time)

    t0 = np.concatenate([spec_r.t_0, spec_b.t_0])
    sigma = np.concatenate([spec_r.sigma, spec_b.sigma])
    rel_amp = np.concatenate([
        (spec_r.peak_jml - spec_r.ss_jml) / spec_r.ss_jml,
        (spec_b.peak_jml - spec_b.ss_jml) / spec_b.ss_jml])
    is_red = [True] * n_r + [False] * n_b
    bursts = torch.tensor(np.stack([t0, sigma, rel_amp], axis=1),
                          dtype=launch_time.dtype,
                          device=launch_time.device)
    return chi_scan(red, launch_time, bursts[:, 0], bursts[:, 1],
                    bursts[:, 2], is_red)


def chi_scan(red: torch.Tensor, launch_time: torch.Tensor, t0, sigma,
             rel_amp, is_red) -> torch.Tensor:
    """Burst factor per cell with the burst parameters given as tensors
    (``t0`` [s], ``sigma`` [s], ``rel_amp``: 1-D, one entry per burst;
    ``is_red``: a sequence of bools), so that a fit can differentiate
    through them (the JAX package's ``fit._chi_scan``).  :func:`chi_field`
    runs this loop on its rounded burst scalars."""
    chi = torch.ones_like(launch_time)
    for t0_i, sig_i, amp_i, red_i in zip(t0, sigma, rel_amp, is_red):
        gauss = amp_i * torch.exp(-(launch_time - t0_i) ** 2 /
                                  (2.0 * sig_i ** 2))
        chi = chi + torch.where(red == bool(red_i), gauss,
                                torch.zeros_like(gauss))
    return chi
