"""Radio recombination line (RRL) physics on tensors (PyTorch port of
rajepy_tpu.ops.rrls).

The LTE (and non-LTE) line physics of the reference's maths/rrls.py,
following Gordon & Sorochenko (2002):

* ``rrl_nu_0``          — rrls.py:14-29       (G&S eq. 1.17)
* ``energy_n``          — rrls.py:32-41       (G&S eq. 1.14)
* ``f_n1n2``            — rrls.py:44-59       (G&S eq. 2.116)
* ``ni_from_ne``        — rrls.py:62-83       (Nieva & Przybilla 2012)
* ``deltanu_l``         — rrls.py:86-101      (Stark FWHM, Smirnov 1985)
* ``deltanu_g``         — rrls.py:104-118     (Doppler FWHM, G&S eq. 2.21)
* ``deltanu_v``         — rrls.py:121-136     (Olivero & Longbothum 1977)
* ``phi_thermal_nu`` / ``phi_stark_nu`` / ``phi_voigt_nu``
                        — rrls.py:275-359 (Voigt via ops.voigt)
* band-integrated profiles ``phi_*_nu_integrated`` — rrls.py:139-272
* ``kappa_l`` / ``kappa_l_average`` — rrls.py:362-425 (G&S eq. 2.114)
* ``line_intensity_lte`` / ``line_continuum_ratio_lte`` — rrls.py:428-464
* non-LTE coefficients  — rrls.py:467-543
* ``rrl_parser``        — rrls.py:605-624

The scalar line constants (``rrl_nu_0``, ``energy_n``, ``f_n1n2``) and
``rrl_parser`` are plain Python.  Profile and opacity functions take
tensors (or Python numbers, promoted to float64 tensors) and broadcast.
cgs units throughout, as the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .. import constants as cnsts
from .voigt import voigt_profile

_KAPPA_L_P0 = 1.0991132675738456e-17  # G&S 2.114 prefactor (rrls.py:383)

# Oscillator-strength M(dn) values (rrls.py:54-57)
_M_DELTA_N = {1: 0.190775, 2: 0.026332, 3: 0.0081056, 4: 0.0034918}

# Mass fractions, Nieva & Przybilla (2012) (rrls.py:72-75)
_XYZ = {'H': 0.710, 'He': 0.276, 'CNO': 0.014}

_SQRT_PI = float(np.sqrt(np.pi))


def _t(x) -> torch.Tensor:
    """A tensor as it is; a Python number or array as a float64 tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def rrl_nu_0(atom: str, n: int, delta_n: int = 1) -> float:
    """RRL rest frequency [Hz] (rrls.py:14-29)."""
    z = cnsts.z_number(atom)
    r = cnsts.rydberg_constant(atom)
    return r * cnsts.C * z ** 2 * (1.0 / n ** 2 - 1.0 / (n + delta_n) ** 2)


def energy_n(n: int, atom: str) -> float:
    """Energy of level n [erg] (rrls.py:32-41)."""
    return -2.17989724e-11 * cnsts.z_number(atom) ** 2 / n ** 2


def f_n1n2(n_1: int, delta_n: int) -> float:
    """Absorption oscillator strength (rrls.py:44-59)."""
    return n_1 * _M_DELTA_N[delta_n] * (1.0 + 1.5 * delta_n / n_1)


def ni_from_ne(n_e, atom: str = 'H'):
    """Ion number density from electron density assuming standard abundances
    (rrls.py:62-83)."""
    mu = (_XYZ['H'] / cnsts.atomic_mass('H') * cnsts.U_AMU +
          _XYZ['He'] / cnsts.atomic_mass('He') * cnsts.U_AMU +
          _XYZ['CNO'] / 14.24) ** -1.0
    m_atom = cnsts.atomic_mass(atom) / cnsts.U_AMU
    return _XYZ[atom] * n_e * mu / m_atom


def deltanu_l(n_e, n: int, delta_n: int, gamma: float = 4.5):
    """Stark (collisional, Lorentzian) FWHM [Hz] (rrls.py:86-101)."""
    return 8.2 * n_e * (n / 100.0) ** gamma * \
        (1.0 + gamma / 2.0 * delta_n / n)


def deltanu_g(nu_0, temp, atom: str):
    """Thermal (Doppler, Gaussian) FWHM [Hz] (rrls.py:104-118)."""
    m = cnsts.atomic_mass(atom)
    return torch.sqrt(4.0 * math.log(2.0) * 2.0 * cnsts.K_B * _t(temp) /
                      (m * cnsts.C ** 2.0)) * nu_0


def deltanu_v(fwhm_thermal, fwhm_stark):
    """Voigt FWHM, Olivero & Longbothum (1977) (rrls.py:121-136)."""
    fwhm_stark = _t(fwhm_stark)
    return 0.5346 * fwhm_stark + torch.sqrt(0.2166 * fwhm_stark ** 2 +
                                            _t(fwhm_thermal) ** 2)


# --------------------------------------------------------------------------- #
# Line profiles (point values)
# --------------------------------------------------------------------------- #
def phi_thermal_nu(nu_0, fwhm_thermal, freq):
    """Gaussian profile [Hz^-1] (rrls.py:275-299)."""
    p1 = math.sqrt(4.0 * math.log(2.0) / math.pi) / _t(fwhm_thermal)
    p2 = torch.exp(-4.0 * math.log(2.0) *
                   ((nu_0 - _t(freq)) / fwhm_thermal) ** 2)
    return p1 * p2


def phi_stark_nu(nu_0, fwhm_stark, freq):
    """Lorentzian profile [Hz^-1] (rrls.py:302-326)."""
    return 2.0 * fwhm_stark / (math.pi * (4.0 * (_t(freq) - nu_0) ** 2 +
                                          fwhm_stark ** 2))


def phi_voigt_nu(nu_0, fwhm_stark, fwhm_thermal, freq):
    """Voigt profile [Hz^-1] (rrls.py:329-359); Faddeeva from ops.voigt."""
    return voigt_profile(_t(freq) - nu_0, fwhm_thermal, fwhm_stark)


# --------------------------------------------------------------------------- #
# Band-integrated line profiles (rrls.py:139-272)
# --------------------------------------------------------------------------- #
def phi_thermal_nu_integrated(freq, nu_0, fwhm_thermal, bw):
    """Gaussian profile integrated over the channel [dimensionless]
    (rrls.py:139-162)."""
    c1 = 1.6651092223153954   # 2 sqrt(ln 2)
    freq = _t(freq)

    def indef(nu):
        return c1 * fwhm_thermal * torch.special.erf(
            c1 * (nu - nu_0) / fwhm_thermal) / (2.0 * c1)

    return indef(freq + bw / 2.0) - indef(freq - bw / 2.0)


def phi_stark_nu_integrated(freq, nu_0, fwhm_stark, bw=1.0):
    """Lorentzian profile integrated over the channel (rrls.py:165-188)."""
    freq = _t(freq)

    def indef(nu):
        return -torch.arctan(2.0 * (nu_0 - nu) / fwhm_stark) / math.pi

    return indef(freq + bw / 2.0) - indef(freq - bw / 2.0)


def _voigt_indef_integral_qa13(x, y, n_sum: int = 30, tau_m: float = 12.0):
    """Indefinite integral I(x, y) of the Voigt function per Quine &
    Abrarov (2013), eqs. 11/15/17 with the paper's three expansion regions
    — the closed form behind the reference's rrls.py:191-272/546-602,
    evaluated branch-free over whole tensors, with the paper's alternating
    sign (the reference writes ``-1. ** n``, always -1)."""
    erf = torch.special.erf
    ns = torch.arange(1, n_sum + 1, dtype=x.dtype, device=x.device)
    pm = math.pi / tau_m
    xe = x[..., None]

    in_central = (x + y * 4.0).abs() <= 4.5
    in_external = (x + y / 1.54545).abs() > 11.0

    # eq. 11 (central): Fourier expansion with erf coefficients
    ty = tau_m * y.clamp_min(0.0)
    small = ty < 1e-8
    ty_safe = torch.where(small, torch.ones_like(ty), ty)
    decay = torch.where(small, 0.5 - ty / 4.0,
                        -torch.expm1(-ty_safe) / (2.0 * ty_safe))
    exp_ty = torch.exp(-ty)
    p2a = 2.0 * erf(x) * decay
    bn = erf(ns * pm + xe) - erf(ns * pm - xe)
    sign = torch.where(ns % 2 == 0, 1.0, -1.0).to(x.dtype)
    p2b = torch.sum(bn * (sign * exp_ty[..., None] - 1.0) /
                    (ns ** 2 * math.pi ** 2 + ty[..., None] ** 2),
                    dim=-1) * ty
    central = (_SQRT_PI / 2.0) * (p2a - p2b)

    # eq. 15 (mid): arctan series; atan2 keeps the y -> 0 limit finite
    an = (2.0 * _SQRT_PI / tau_m) * torch.exp(-(ns * math.pi / tau_m) ** 2)
    ye = y[..., None]
    mid = (torch.atan2(x, y) / tau_m +
           torch.sum((torch.atan2(xe + ns * pm, ye) +
                      torch.atan2(xe - ns * pm, ye)) * an,
                     dim=-1) / (2.0 * _SQRT_PI))

    # eq. 17 (external): asymptotic form
    ext = (torch.atan2(x, y) / _SQRT_PI -
           x * y / (2.0 * _SQRT_PI * (x ** 2 + y ** 2) ** 2))

    out = torch.where(in_central, central,
                      torch.where(in_external, ext, mid))
    return out / _SQRT_PI


def phi_voigt_nu_integrated(freq, nu_0, fwhm_thermal, fwhm_stark, bw,
                            average: bool = True, method: str = 'qa13'):
    """Voigt profile integrated across the channel (rrls.py:191-272).

    ``method='qa13'`` (default) evaluates the Quine & Abrarov (2013)
    indefinite-integral series at the channel edges; ``method='quad'``
    integrates the point profile with 16-point Gauss-Legendre quadrature.
    """
    freq = _t(freq)
    if not freq.dtype.is_floating_point:
        freq = freq.to(torch.float64)
    if method == 'qa13':
        y = torch.broadcast_to(
            _t(0.8325546111576977 * fwhm_stark / fwhm_thermal).to(
                freq.dtype), freq.shape)
        c = 1.6651092223153954  # 2 sqrt(ln 2): fwhm -> 1/e half width

        def indef(nu):
            x = c * (nu - nu_0) / fwhm_thermal
            return _voigt_indef_integral_qa13(_t(x), y)

        area = indef(freq + bw / 2.0) - indef(freq - bw / 2.0)
        return area / bw if average else area
    if method != 'quad':
        raise ValueError(f"unknown method {method!r}")
    xs, ws = np.polynomial.legendre.leggauss(16)
    half = bw / 2.0
    total = 0.0
    for i in range(16):
        nu = freq + half * float(xs[i])
        total = total + float(ws[i]) * phi_voigt_nu(nu_0, fwhm_stark,
                                                    fwhm_thermal, nu)
    area = total * half
    return area / bw if average else area


# --------------------------------------------------------------------------- #
# Opacity and intensity
# --------------------------------------------------------------------------- #
def kappa_l(freq, n, oscillator_strength, line_profile, n_e, n_i, temp, z,
            energy_n1):
    """RRL LTE absorption coefficient kappa_L [cm^-1], G&S eq. 2.114
    (rrls.py:362-389)."""
    temp = _t(temp)
    p1 = n ** 2.0 * oscillator_strength * line_profile
    p2 = n_e * n_i / temp ** 1.5
    p3 = torch.exp((z ** 2.0 * energy_n1) / (cnsts.K_CGS * temp))
    p4 = -torch.expm1(-cnsts.H_CGS * freq / (cnsts.K_CGS * temp))
    return _KAPPA_L_P0 * p1 * p2 * p3 * p4


def kappa_l_average(freq, n, oscillator_strength, av_line_profile, n_e, n_i,
                    temp, z, energy_n1, bw):
    """Channel-averaged kappa_L (rrls.py:392-425): the stimulated-emission
    factor is integrated in closed form across the channel."""
    temp = _t(temp)
    p1 = n ** 2.0 * oscillator_strength * av_line_profile
    p2 = n_e * n_i / temp ** 1.5
    p3 = torch.exp((z ** 2.0 * energy_n1) / (cnsts.K_CGS * temp))

    def indef(nu):
        return cnsts.K_CGS * temp * torch.exp(
            -cnsts.H_CGS * nu / (cnsts.K_CGS * temp)) / cnsts.H_CGS + nu

    ev = indef(freq + bw / 2.0) - indef(freq - bw / 2.0)
    return _KAPPA_L_P0 * p1 * p2 * p3 * ev / bw


def line_intensity_lte(freq, temp, tau_c, tau_l):
    """LTE RRL intensity [W m^-2 Hz^-1 sr^-1], G&S eq. 2.122
    (rrls.py:428-449)."""
    from .physics import blackbody_nu
    b_nu = blackbody_nu(freq, _t(temp))
    # -expm1(-tau) keeps optically thin lines (tau << f32 eps) from
    # cancelling to zero in exp(-tau) - 1 arithmetic
    i_l_cgs = b_nu * torch.exp(-_t(tau_c)) * (-torch.expm1(-_t(tau_l)))
    return i_l_cgs * 1e-7 * 1e4


def line_continuum_ratio_lte(tau_c, tau_l):
    """LTE line-to-continuum ratio (rrls.py:452-464)."""
    return (-torch.expm1(-_t(tau_l))) / torch.expm1(_t(tau_c))


# --------------------------------------------------------------------------- #
# Non-LTE coefficients (rrls.py:467-543)
# --------------------------------------------------------------------------- #
def beta_coeff(freq, temp, b_n1, b_n2):
    """G&S eq. 2.130 (rrls.py:467-485), (1 - (b_n2/b_n1) e^-x) / (1 - e^-x)
    with x = h nu / k T, regrouped as 1 - (b_n2 - b_n1) / (b_n1 expm1(x)).

    At radio lines x ~ 1e-4 and b_n2 / b_n1 - 1 ~ 1e-5, so the textbook
    form cancels: in float32 both its numerator and denominator lose three
    to four of float32's seven digits, and a non-LTE line flux with them;
    the regrouped form has no difference of nearly equal terms but
    b_n2 - b_n1, which is exact."""
    x = cnsts.H * _t(freq) / (cnsts.K_B * temp)
    return 1.0 - (b_n2 - b_n1) / (b_n1 * torch.expm1(x))


def tau_nu_coeff(beta, tau_c, tau_l_star, b_n1):
    """G&S eq. 2.141 (rrls.py:488-502)."""
    return tau_c + tau_l_star * b_n1 * beta


def eta_coeff(b_n1, b_n2, kappa_c, kappa_l_star, beta):
    """G&S eq. 2.139 (rrls.py:505-525)."""
    kappa_ratio = kappa_l_star / kappa_c
    return (1.0 + b_n2 * kappa_ratio) / (1.0 + b_n1 * kappa_ratio * beta)


def line_continuum_ratio_nonlte(eta, tau_nu, tau_c):
    """G&S eq. 2.140 (rrls.py:528-543)."""
    return eta * (1.0 - torch.exp(-_t(tau_nu))) / \
        (1.0 - torch.exp(-_t(tau_c))) - 1.0


def line_intensity_nonlte(freq, temp, tau_c, tau_l_star, b_n1, b_n2):
    """Non-LTE slab line intensity [W m^-2 Hz^-1 sr^-1] given departure
    coefficients (b_n1, b_n2) for the transition's lower/upper levels
    (beyond the reference, which raises on ``lte=False``):

        I_L = B_nu(T) [ eta (1 - e^-tau_nu) - (1 - e^-tau_c) ]

    with tau_nu = tau_c + b_n1 beta tau_L* and eta from the LTE
    line/continuum opacity ratio; exactly :func:`line_intensity_lte` at
    b_n1 = b_n2 = 1.  ``tau_l_star`` is the LTE line opacity."""
    from .physics import blackbody_nu
    temp, tau_c, tau_l_star = _t(temp), _t(tau_c), _t(tau_l_star)
    beta = beta_coeff(freq, temp, b_n1, b_n2)
    pos = tau_c > 0
    safe_tc = torch.where(pos, tau_c, torch.ones_like(tau_c))
    ratio = torch.where(pos, tau_l_star / safe_tc,
                        torch.zeros_like(tau_l_star))
    # cancellation-free regrouping of eta (1 - e^-tau_nu) - (1 - e^-tau_c):
    # eta - 1 is formed directly (exact 0 at b = 1), and the line term
    # through expm1 of the non-LTE line opacity alone
    denom = 1.0 + b_n1 * ratio * beta
    eta_m1 = ratio * (b_n2 - b_n1 * beta) / denom
    tau_l_eff = b_n1 * beta * tau_l_star
    b_nu = blackbody_nu(freq, temp)
    i_l_cgs = b_nu * (eta_m1 * (-torch.expm1(-tau_c)) +
                      (1.0 + eta_m1) * torch.exp(-tau_c) *
                      (-torch.expm1(-tau_l_eff)))
    return i_l_cgs * 1e-7 * 1e4


def rrl_parser(rrl_str: str) -> Tuple[str, int, int]:
    """'H58a' -> ('H', 58, 1) etc. (rrls.py:605-624)."""
    dn = {'a': 1, 'b': 2, 'g': 3, 'd': 4}[rrl_str[-1].lower()]
    element = ''.join(ch for ch in rrl_str[:-1] if ch.isalpha())
    n = int(''.join(ch for ch in rrl_str[:-1] if not ch.isalpha()))
    return element, n, dn
