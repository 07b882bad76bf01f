"""Reynolds (1986) jet physics used by the continuum main path (PyTorch
port of the matching part of rajepy_tpu.ops.physics).

* ``q_n``           — reference physics.py:17-35
* ``q_tau``         — physics.py:38-63
* ``v_rot``         — physics.py:66-90
* ``tau_r``, ``tau_r_from_params``, ``tau_r_from_jm`` — physics.py:93-178
  (Reynolds eq. 4; scalars or tensors)
* ``r_tau1``        — physics.py:181-236
* ``approx_flux_expected_r86`` — physics.py:239-294 (Reynolds eq. 16)
* ``flux_expected_r86`` — physics.py:297-374 (Reynolds eq. 8, exact; the
  reference's mpmath.gammainc becomes an upper incomplete gamma from
  scipy's regularised gammaincc and the recurrence that lifts negative
  orders)
* ``flux_int_wrapped`` — physics.py:377-425
* ``mlr_from_n_0`` / ``n_0_from_mlr`` — physics.py:428-517
* ``doppler_shift``, ``blackbody_nu``, ``nu_rrl`` — the RRL relations,
  physics.py:547-604
* Shakura & Sunyaev (1973) disc relations — physics.py:703-931

The analytic formulas take and return host scalars or numpy arrays; the
relations used inside the grid fill and the RT take tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as cnsts
from . import geometry as geom


def q_n(epsilon, q_v):
    """Mass-conserving density power-law index (physics.py:17-35).  Floats
    or 0-d tensors, as :func:`q_tau`, :func:`n_0_from_mlr` and
    :func:`doppler_shift` (the fit's derivation chain)."""
    return -q_v - 2.0 * epsilon


def q_tau(epsilon, q_x, q_n_, q_T):
    """Optical-depth power-law index (physics.py:38-63)."""
    return epsilon + 2.0 * q_x + 2.0 * q_n_ - 1.35 * q_T


def v_rot(r, reff, rho, epsilon, m_star):
    """Keplerian rotation at launch radius reff, declining as rho^-eps along
    the jet; km/s (physics.py:66-90).  ``reff`` in au, ``m_star`` in Msol."""
    return torch.sqrt(cnsts.G * m_star * cnsts.MSOL /
                      (reff * cnsts.AU)) * rho ** -epsilon / 1e3


# --------------------------------------------------------------------------- #
# Reynolds (1986) analytic optical depth and flux
# --------------------------------------------------------------------------- #
def tau_r(r, r_0, w_0, n_0, chi_0, T_0, freq, inc, epsilon, q_n_, q_x, q_T,
          opang):
    """Optical depth across the jet at axis distance r [au] — Reynolds (1986)
    eq. 4 (physics.py:93-143)."""
    w0_cm = w_0 * cnsts.AU2CM
    mr0 = geom.mod_r_0(opang, epsilon, w0_cm)
    q = q_tau(epsilon, q_x, q_n_, q_T)
    rho_ = geom.rho(r * cnsts.AU2CM, r_0 * cnsts.AU2CM, mr0)
    return (2.0 * cnsts.a_k * w0_cm * n_0 ** 2.0 * chi_0 ** 2.0 *
            T_0 ** -1.35 * rho_ ** q * freq ** -2.1 /
            math.sin(math.radians(inc)))


def tau_r_from_params(params: dict, freq, r):
    """``tau_r`` with arguments extracted from a model params dict
    (physics.py:146-178)."""
    g, p, pl = params['geometry'], params['properties'], params['power_laws']
    return tau_r(r, g['r_0'], g['w_0'], p['n_0'], p['x_0'], p['T_0'], freq,
                 g['inc'], g['epsilon'], pl['q_n'], pl['q_x'], pl['q_T'],
                 g['opang'])


def tau_r_from_jm(jm, freq, r):
    """``tau_r`` with arguments extracted from a JetModel instance
    (physics.py:146-178)."""
    return tau_r_from_params(jm.params, freq, r)


def r_tau1(r_0, w_0, n_0, chi_0, T_0, freq, inc, epsilon, q_n_, q_x, q_T,
           opang, dist=None):
    """Distance to the tau = 1 surface; au, or arcsec when ``dist`` [pc] is
    given (physics.py:181-236)."""
    w0_cm = w_0 * cnsts.AU2CM
    m_r_0 = geom.mod_r_0(opang, epsilon, w0_cm)
    q = q_tau(epsilon, q_x, q_n_, q_T)
    rho_ = (2.0 * cnsts.a_k * w0_cm * n_0 ** 2.0 * chi_0 ** 2.0 *
            T_0 ** -1.35 * freq ** -2.1 /
            np.sin(np.radians(inc))) ** (-1.0 / q)
    r = rho_ * m_r_0 + r_0 * cnsts.AU2CM - m_r_0
    if dist is None:
        return r
    return r / cnsts.AU2CM / dist


def _gamma_upper(s: float, x):
    """Unregularised upper incomplete gamma Gamma(s, x) for real s
    (including zero and negative integers) and x > 0.  Replaces
    mpmath.gammainc at physics.py:367.

    Non-integer s: lift with Gamma(s, x) = (Gamma(s+1, x) - x^s e^-x)/s
    to s > 0, then scipy's regularised gammaincc.  AT a non-positive
    integer that recurrence divides by zero, so integer orders anchor on
    Gamma(0, x) = E_1(x) and step DOWN with
    Gamma(s-1, x) = (Gamma(s, x) - x^(s-1) e^-x)/(s-1) — each step
    divides by a negative integer, never zero.  The 1e-8 snap window is
    the crossover where the lift's cancellation error (~1e-16/|s-n|)
    exceeds the snap's truncation error (~0.3 |s-n|)."""
    from math import gamma as _g
    from scipy.special import exp1, gammaincc
    x = np.asarray(x, dtype=float)
    n_near = round(s)
    if n_near <= 0 and abs(s - n_near) < 1e-8:
        s_int = int(n_near)
        val = exp1(x)
        s_k = 0
        while s_k > s_int:
            val = (val - x ** (s_k - 1) * np.exp(-x)) / (s_k - 1)
            s_k -= 1
        return val
    n_lift = max(0, int(np.ceil(-s)) + 1)
    s_top = s + n_lift
    val = gammaincc(s_top, x) * _g(s_top)
    for k in range(n_lift):
        s_k = s_top - 1 - k
        val = (val - x ** s_k * np.exp(-x)) / s_k
    return val


def _blue_n_0(params: dict) -> float:
    """n_0 choice of the analytic flux formulas: even-density equivalent when
    the disc-wind density cross-section is active (physics.py:264-270)."""
    if params['power_laws']['q^d_n'] != 0.0:
        w0_cm = params['geometry']['w_0'] * cnsts.AU2CM
        mlr = params['properties']['mlr_bj'] * 1.989e30 / cnsts.YEAR
        return mlr / (np.pi * params['properties']['mu'] *
                      cnsts.atomic_mass('H') * w0_cm ** 2.0 *
                      params['properties']['v_0'] * 1e5)
    return params['properties']['n_0']


def approx_flux_expected_r86(params: dict, freq, which: str = 'B',
                             rb_frac: float = 1.0):
    """Approximate monopolar-jet flux, Reynolds (1986) eq. 16
    (physics.py:239-294).  ``rb_frac`` scales n_0 for the red jet (the
    reference multiplies by ss_jml('R')/ss_jml('B'), physics.py:272-273).
    Returns Jy."""
    freq = np.asarray(freq, dtype=float)
    g, p, pl, t = (params['geometry'], params['properties'],
                   params['power_laws'], params['target'])
    w_0 = g['w_0'] * cnsts.AU2CM
    n_0 = _blue_n_0(params)
    if which == 'R':
        n_0 = n_0 * rb_frac

    c = (1.0 + g['epsilon'] + pl['q_T']) / pl['q_tau']
    flux = 2.0 ** (1.0 - c) * (t['dist'] * cnsts.PARSEC * 1e2) ** -2.0
    flux *= cnsts.a_j * cnsts.a_k ** (-1.0 - c) * p['T_0'] ** (1.0 + 1.35 * c)
    flux *= g['mod_r_0'] * cnsts.AU2CM
    flux *= w_0 ** (1.0 - c)
    flux *= (n_0 * p['x_0']) ** (-2.0 * c)
    flux *= np.sin(np.radians(g['inc'])) ** (1.0 + c) / \
        (c * (1.0 + g['epsilon'] + pl['q_T'] + pl['q_tau']))
    alpha = 2.0 + (2.1 / pl['q_tau']) * (1.0 + g['epsilon'] + pl['q_T'])
    flux = flux * freq ** alpha           # erg s^-1 cm^-2 Hz^-1
    flux *= 1e-7 * 1e2 ** 2.0             # -> W m^-2 Hz^-1
    return flux / 1e-26                   # -> Jy


def flux_expected_r86(params: dict, freq, y_max, y_min=None,
                      which: str = 'B', rb_frac: float = 1.0):
    """Exact monopolar-jet flux, Reynolds (1986) eq. 8 (physics.py:297-374).
    ``y_max``/``y_min`` are angular extents in arcsec.  Returns Jy."""
    g, p, pl, t = (params['geometry'], params['properties'],
                   params['power_laws'], params['target'])
    inc = g['inc']
    w_0 = g['w_0'] * cnsts.AU2CM
    T_0 = p['T_0']
    n_0 = p['n_0']
    if which == 'R':
        n_0 = n_0 * rb_frac
    x_0 = p['x_0']
    q_tau_ = pl['q_tau']
    q_T = pl['q_T']
    eps = g['epsilon']
    mod_r_0 = g['mod_r_0'] * cnsts.AU2CM
    mod_y_0 = mod_r_0 * np.sin(np.radians(inc))
    r_0 = g['r_0'] * cnsts.AU2CM
    y_0 = r_0 * np.sin(np.radians(inc))
    d = t['dist'] * cnsts.PARSEC * 1e2

    if pl['q^d_n'] != 0.0:
        n_0 = _blue_n_0(params)
        if which == 'R':
            n_0 = n_0 * rb_frac

    y_max = np.tan(y_max * cnsts.ARCSEC) * d + mod_y_0 - y_0
    if y_min is not None:
        y_min = np.tan(y_min * cnsts.ARCSEC) * d + mod_y_0 - y_0
    else:
        y_min = mod_y_0

    tau_0 = (2.0 * cnsts.a_k * w_0 * (n_0 * x_0) ** 2.0 * T_0 ** -1.35 *
             freq ** -2.1 / np.sin(np.radians(inc)))
    c = 1.0 + eps + q_T

    def indef(yval):
        const = (2.0 * w_0 * d ** -2.0 * cnsts.a_j / cnsts.a_k * T_0 *
                 freq ** 2.0)
        rho_ = yval / mod_y_0
        tau = tau_0 * rho_ ** q_tau_
        p1 = yval / (q_tau_ * c) * rho_ ** (c - 1.0) * tau ** (-c / q_tau_)
        p2 = q_tau_ * tau ** (c / q_tau_) + c * _gamma_upper(c / q_tau_, tau)
        return const * p1 * p2

    flux = indef(y_max) - indef(y_min)
    flux *= 1e-7 * 1e2 ** 2.0
    return flux / 1e-26


def flux_int_wrapped(freq: float, params: dict):
    """Integrand factory for direct numerical integration of the monopolar
    free-free flux over (z, x, y) model coordinates (physics.py:377-425);
    a quadrature cross-check of the grid RT, not used by the pipeline."""
    g, p, pl, t = (params['geometry'], params['properties'],
                   params['power_laws'], params['target'])
    inc = g['inc']
    w_0 = g['w_0'] * cnsts.AU2CM
    T_0 = p['T_0']
    n_0 = p['n_0']
    x_0 = p['x_0']
    eps = g['epsilon']
    mod_r_0 = g['mod_r_0'] * cnsts.AU2CM
    r_0 = g['r_0'] * cnsts.AU2CM
    r_1, r_2 = t['R_1'], t['R_2']
    dist = t['dist'] * cnsts.PARSEC * 1e2
    q_n_, q_x, q_T = pl['q_n'], pl['q_x'], pl['q_T']
    q_nd, q_xd, q_Td = pl['q^d_n'], pl['q^d_x'], pl['q^d_T']

    i_rad = np.radians(inc - 90.0)

    def func(z, x, y):
        # scalar jet-frame transform (pa = 0, as the reference's
        # integrand).  r stays SIGNED: the reference's gate `r < r_0`
        # rejects the entire red side — the integrand is monopolar
        # (physics.py:403), so a quadrature spanning z < 0 must see 0
        # there, not a mirrored blue jet
        yd = np.cos(i_rad) * y - np.sin(i_rad) * z
        r = np.sin(i_rad) * y + np.cos(i_rad) * z
        rho1 = (abs(r) + mod_r_0 - r_0) / mod_r_0
        wr = w_0 * rho1 ** eps
        w = np.hypot(x, yd)
        if w > wr or r < r_0:
            return 0.0
        # post-gate r >= r_0 > 0, so the abs in rho1 is inert
        reff = r_1 + (r_2 - r_1) * w / wr
        tau = (cnsts.a_k * n_0 ** 2.0 * x_0 ** 2.0 * T_0 ** -1.35 *
               freq ** -2.1 *
               rho1 ** (2.0 * q_n_ + 2.0 * q_x - 1.35 * q_T) *
               (reff / r_1) ** (2.0 * q_nd + 2.0 * q_xd - 1.35 * q_Td))
        temp = T_0 * rho1 ** q_T * (reff / r_1) ** q_Td
        return (dist ** -2.0 * cnsts.a_j / cnsts.a_k * temp *
                freq ** 2.0 * (1.0 - np.exp(-tau)))

    return func


# --------------------------------------------------------------------------- #
# Mass-loss rate <-> base density
# --------------------------------------------------------------------------- #
def _mlr_shape_factor(a: float, r1: float, r2: float) -> float:
    """Closed-form cross-section integral shared by mlr<->n_0
    (physics.py:469-471)."""
    if a == -1.0 or a == -2.0:
        a = a * (1.0 + 1e-12)
    return ((r1 ** 2.0 + r2 * (r2 * (a + 1.0) - r1 * (a + 2.0)) *
             (r2 / r1) ** a) /
            ((r2 - r1) ** 2.0 * (a + 1.0) * (a + 2.0)))


def mlr_from_n_0(n_0, v_0, w_0, mu, q_nd, q_nv, R_1, R_2):
    """Jet mass-loss rate [Msol/yr] from base density [cm^-3]
    (physics.py:428-471)."""
    a = q_nd + q_nv
    r1, r2 = R_1 * cnsts.AU, R_2 * cnsts.AU
    const = (2.0 * np.pi * mu * cnsts.atomic_mass('H') * (n_0 * 1e6) *
             (v_0 * 1e3) * (w_0 * cnsts.AU) ** 2.0)
    return const * _mlr_shape_factor(a, r1, r2) / cnsts.MSOL * cnsts.YEAR


def n_0_from_mlr(mlr, v_0, w_0, mu, q_nd, q_nv, R_1, R_2):
    """Base density [cm^-3] from jet mass-loss rate [Msol/yr]
    (physics.py:474-517)."""
    a = q_nd + q_nv
    r1, r2 = R_1 * cnsts.AU, R_2 * cnsts.AU
    mlr_si = mlr * cnsts.MSOL / cnsts.YEAR
    const = (2.0 * math.pi * mu * cnsts.atomic_mass('H') * (v_0 * 1e3) *
             (w_0 * cnsts.AU) ** 2.0)
    return mlr_si / const / _mlr_shape_factor(a, r1, r2) / 1e6


# --------------------------------------------------------------------------- #
# Radiative relations used by the RRL products
# --------------------------------------------------------------------------- #
def doppler_shift(nu_0, v_lsr):
    """Doppler-shifted frequency; v_lsr in km/s, receding positive
    (physics.py:547-558)."""
    return nu_0 * (1.0 - v_lsr * 1e3 / cnsts.C)


# cube root of the Planck prefactor 2h/c^2 [cgs]: the prefactor itself
# (1.5e-47) underflows float32; its cube root (2.47e-16) does not, and
# (a nu)^3 stays normal for every radio-to-IR frequency (nu > ~4e2 Hz)
_BB_PREFACTOR_CBRT = float((2.0 * cnsts.H_CGS / cnsts.C_CGS ** 2) **
                           (1.0 / 3.0))


def blackbody_nu(freq, temp):
    """Planck spectral radiance B_nu in cgs (erg s^-1 cm^-2 Hz^-1 sr^-1)
    (physics.py:561-574), as ((2h/c^2)^(1/3) nu)^3 / expm1(h nu / k T) so
    that no float32 intermediate underflows; expm1 keeps the
    Rayleigh-Jeans limit (h nu / k T ~ 1e-5) accurate."""
    t = _BB_PREFACTOR_CBRT * freq
    return t * t * t / torch.expm1(cnsts.H_CGS * freq / (cnsts.K_CGS * temp))


def nu_rrl(n, dn=1, atom="H"):
    """Radio recombination line frequency, reduced-mass Rydberg
    (physics.py:577-604)."""
    n_p, _ = cnsts.NZ[atom]
    mass = cnsts.atomic_mass(atom) - cnsts.M_E * n_p
    r_m = cnsts.RYDBERG / (1.0 + cnsts.M_E / mass)
    return r_m * cnsts.C * (1.0 / n ** 2.0 - 1.0 / (n + dn) ** 2.0)


# --------------------------------------------------------------------------- #
# Shakura & Sunyaev (1973) alpha-disc relations (physics.py:703-931)
# --------------------------------------------------------------------------- #
def _ss73_scaled(alpha, acc_rate, m_yso, radius, zone):
    if zone != 'c':
        raise ValueError("Only disc-zone c from Shakura & Sunyaev (1973) "
                         "is currently implemented")
    m_dot = acc_rate / 3e-8 / m_yso
    r = (radius * cnsts.AU) / 9000.0 / m_yso
    return m_dot, r


def u0_ss73(alpha, acc_rate, m_yso, radius, zone='c'):
    """Disc surface density [g cm^-2] (physics.py:703-733)."""
    m_dot, r = _ss73_scaled(alpha, acc_rate, m_yso, radius, zone)
    return (6.1e5 * alpha ** -0.8 * m_dot ** 0.7 * m_yso ** 0.2 *
            r ** -0.75 * (1.0 - r ** -0.5) ** 0.7)


def temp_ss73(alpha, acc_rate, m_yso, radius, zone='c'):
    """Disc temperature [K] (physics.py:736-766)."""
    m_dot, r = _ss73_scaled(alpha, acc_rate, m_yso, radius, zone)
    return (8.6e7 * alpha ** -0.2 * m_dot ** 0.3 * m_yso ** -0.2 *
            r ** -0.75 * (1.0 - r ** -0.5) ** 0.3)


def z0_ss73(alpha, acc_rate, m_yso, radius, zone='c'):
    """Disc scale height [au] (physics.py:769-799)."""
    m_dot, r = _ss73_scaled(alpha, acc_rate, m_yso, radius, zone)
    return (6.1e3 * alpha ** -0.1 * m_dot ** 0.15 * m_yso ** 0.9 *
            r ** (9.0 / 8.0) * (1.0 - r ** -0.5) ** 0.15) / 1e2 / cnsts.AU


def n_ss73(alpha, acc_rate, m_yso, radius, zone='c'):
    """Disc number density [cm^-3] (physics.py:802-832)."""
    m_dot, r = _ss73_scaled(alpha, acc_rate, m_yso, radius, zone)
    return (3e25 * alpha ** -0.7 * m_dot ** 0.55 * m_yso ** -0.7 *
            r ** (-15.0 / 8.0) * (1.0 - r ** -0.5) ** 0.55)


def tau_ss73(alpha, acc_rate, m_yso, radius, zone='c'):
    """Disc optical depth (physics.py:835-865)."""
    m_dot, r = _ss73_scaled(alpha, acc_rate, m_yso, radius, zone)
    return (3.4e2 * alpha ** -0.8 * m_dot ** 0.2 * m_yso ** 0.2 *
            (1.0 - r ** -0.5) ** 0.2)


def vr_ss73(alpha, acc_rate, m_yso, radius, zone='c'):
    """Disc radial velocity [cm/s] (physics.py:868-898)."""
    m_dot, r = _ss73_scaled(alpha, acc_rate, m_yso, radius, zone)
    return (5.8e5 * alpha ** 0.8 * m_dot ** 0.3 * m_yso ** -0.2 *
            r ** -0.25 * (1.0 - r ** -0.5) ** -0.7)


def h_ss73(alpha, acc_rate, m_yso, radius, zone='c'):
    """Disc magnetic-field upper limit [G] (physics.py:901-931)."""
    m_dot, r = _ss73_scaled(alpha, acc_rate, m_yso, radius, zone)
    return (2.1e9 * alpha ** 0.05 * m_dot ** 0.425 * m_yso ** -0.45 *
            r ** (-21.0 / 16.0) * (1.0 - r ** -0.5) ** 0.425)
