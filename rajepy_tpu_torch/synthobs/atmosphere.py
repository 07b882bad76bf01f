"""Atmosphere-dependent system temperature for the thermal-noise model.

The reference's simobserve runs CASA's ``thermalnoise='tsys-atm'`` mode,
which derives Tsys(nu, elevation, pwv) from the ATM atmospheric model with
``user_pwv`` / ``t_ground`` knobs (casa/tasks.py:196-206).
This module is a compact parametric stand-in (equivalence is statistical,
matching CASA's behaviour in trend and, at the anchor points below, in
magnitude — not bitwise): a two-component zenith opacity — a dry term
with the O2 60-GHz band and 118.75 GHz line, and a wet term linear in
precipitable water vapour with the 22.235/183.31/325.15 GHz H2O lines
plus the mm continuum — propagated through the single-slab radiative
Tsys equation referenced above the atmosphere.

External anchors (tests/test_synthobs.py::TestAtmosphereAnchors):

* tau_225(pwv) = 0.0059 + 0.042 pwv[mm] — the Chajnantor-style 225 GHz
  tipping-radiometer site fit, EXACT by construction (the wet continuum
  coefficient is solved so line wings + continuum hit 0.042/mm at
  225 GHz); the independent Mauna Kea CSO fit pwv = 20 (tau_225 - 0.016)
  brackets the same curve to ~30%, which is the honest inter-site spread
  of such fits and the model's accuracy tier for window opacities.
* the 183.31 GHz H2O line saturates (zenith tau > 3 at 0.5 mm pwv —
  why ALMA's water-vapour radiometers observe it), ~6.3/mm at centre.
* the 60 GHz O2 complex is opaque (tau ~ 20 through the whole band,
  modelled as a Gaussian band so its wings do NOT pollute the 90 GHz
  window the way a Lorentzian would).
* 3 mm window: tau(90 GHz, 1 mm) ~ 0.01-0.08; 345/225 GHz wet-opacity
  ratio 2.0-3.2 (f^2 continuum + the 325 GHz line wing).

The per-telescope catalogue SEFDs (observatories.DEFAULT_SEFD) stay the
calibration anchor: :func:`sefd_scale` returns the ratio of Tsys at the
observing conditions to Tsys at the reference conditions (zenith, 1 mm
pwv), so 'tsys-atm' reduces to the flat radiometer model there and scales
physically away from it.  Valid ~1-350 GHz.

A copy of rajepy_tpu.synthobs.atmosphere, which holds no JAX.
"""
from __future__ import annotations

import numpy as np

T_CMB = 2.725
REF_PWV_MM = 1.0
REF_ELEVATION_DEG = 90.0

# wet H2O lines: (centre GHz, amplitude nepers/mm at centre, HWHM GHz)
_H2O_LINES = ((22.235, 0.013, 2.5),
              (183.31, 6.3, 1.6),
              (325.15, 1.5, 2.0))
#: total wet opacity per mm pwv at 225 GHz (the site-fit slope)
_TAU225_WET_PER_MM = 0.042
#: dry opacity at 225 GHz (the site-fit intercept)
_TAU225_DRY = 0.0059


def _lorentz(f_ghz, f0_ghz, gamma_ghz):
    return gamma_ghz ** 2 / ((f_ghz - f0_ghz) ** 2 + gamma_ghz ** 2)


def _wet_lines(f):
    out = 0.0
    for f0, amp, gam in _H2O_LINES:
        out = out + amp * _lorentz(f, f0, gam)
    return out


# wet continuum coefficient solved so that lines + continuum give
# exactly _TAU225_WET_PER_MM at 225 GHz
_WET_CONT = _TAU225_WET_PER_MM - float(_wet_lines(225.0))


def _dry(f):
    # continuum (~f^2) + the O2 60 GHz band as a GAUSSIAN band (a
    # Lorentzian's wings would add ~0.3 nepers at 90 GHz where the real
    # window opacity is ~0.03) + the 118.75 GHz O2 line; the continuum
    # constant is solved so tau_dry(225) = _TAU225_DRY
    band = (20.0 * np.exp(-((f - 60.0) / 7.0) ** 2) +
            1.0 * _lorentz(f, 118.75, 1.0))
    return 4.0e-8 * f ** 2 + band


_DRY_CONST = _TAU225_DRY - float(_dry(225.0))


def zenith_opacity(freq_hz, pwv_mm: float):
    """Zenith atmospheric opacity tau(nu) [nepers].

    Dry: continuum + the O2 60 GHz band and 118.75 GHz line.  Wet (per
    mm pwv): H2O lines at 22.235 (weak), 183.31 (saturated) and
    325.15 GHz + the f^2 mm continuum; calibrated so
    tau(225 GHz) = 0.0059 + 0.042 pwv exactly (module docstring
    anchors).
    """
    f = np.asarray(freq_hz, dtype=float) / 1e9
    tau_dry = _DRY_CONST + _dry(f)
    k_wet = _WET_CONT * (f / 225.0) ** 2 + _wet_lines(f)
    return tau_dry + float(pwv_mm) * k_wet


def receiver_temperature(freq_hz):
    """Default receiver temperature trend T_rx(nu) ~ 15 K + 0.4 K/GHz —
    the generic LNA scaling; pass an explicit ``t_rx`` to override."""
    return 15.0 + 0.4 * np.asarray(freq_hz, dtype=float) / 1e9


def tsys(freq_hz, elevation_deg: float, pwv_mm: float,
         t_ground: float = 270.0, t_rx=None):
    """System temperature [K] referenced above the atmosphere:

        Tsys = (T_rx + T_atm (1 - e^-tau A) + T_cmb e^-tau A) e^{+tau A}

    with airmass A = 1/sin(el) and the effective atmosphere temperature
    T_atm ~ 0.95 T_ground (single-slab approximation; CASA's ATM
    integrates a profile — tasks.py:196-206).
    """
    el = max(float(elevation_deg), 5.0)  # clamp below 5 deg (model break)
    airmass = 1.0 / np.sin(np.radians(el))
    tau = zenith_opacity(freq_hz, pwv_mm) * airmass
    t = np.exp(-tau)
    t_atm = 0.95 * float(t_ground)
    t_rx = receiver_temperature(freq_hz) if t_rx is None else \
        np.asarray(t_rx, dtype=float)
    return (t_rx + t_atm * (1.0 - t) + T_CMB * t) / t


def sefd_scale(freq_hz, elevation_deg: float, pwv_mm: float,
               t_ground: float = 270.0, t_rx=None):
    """Multiplier on the catalogue SEFD: Tsys at the observing conditions
    over Tsys at the reference conditions (zenith, 1 mm pwv, same
    frequency and receiver).  >= ~1 for el < 90 or pwv > 1 mm."""
    now = tsys(freq_hz, elevation_deg, pwv_mm, t_ground, t_rx)
    ref = tsys(freq_hz, REF_ELEVATION_DEG, REF_PWV_MM, t_ground, t_rx)
    return now / ref
