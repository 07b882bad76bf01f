"""Reynolds (1986) jet physics used by the continuum main path (PyTorch
port of the matching part of rajepy_tpu.ops.physics).

* ``q_n``           — reference physics.py:17-35
* ``q_tau``         — physics.py:38-63
* ``v_rot``         — physics.py:66-90
* ``tau_r``, ``tau_r_from_params``, ``tau_r_from_jm`` — physics.py:93-178
  (Reynolds eq. 4; scalars or tensors)
* ``n_0_from_mlr``  — physics.py:474-517
* ``doppler_shift``, ``blackbody_nu``, ``nu_rrl`` — the RRL relations,
  physics.py:547-604

The analytic flux formulas and the disc model of the JAX module are not
ported yet.
"""
from __future__ import annotations

import math

import torch

from .. import constants as cnsts
from . import geometry as geom


def q_n(epsilon: float, q_v: float) -> float:
    """Mass-conserving density power-law index (physics.py:17-35)."""
    return -q_v - 2.0 * epsilon


def q_tau(epsilon: float, q_x: float, q_n_: float, q_T: float) -> float:
    """Optical-depth power-law index (physics.py:38-63)."""
    return epsilon + 2.0 * q_x + 2.0 * q_n_ - 1.35 * q_T


def v_rot(r, reff, rho, epsilon, m_star):
    """Keplerian rotation at launch radius reff, declining as rho^-eps along
    the jet; km/s (physics.py:66-90).  ``reff`` in au, ``m_star`` in Msol."""
    return torch.sqrt(cnsts.G * m_star * cnsts.MSOL /
                      (reff * cnsts.AU)) * rho ** -epsilon / 1e3



# --------------------------------------------------------------------------- #
# Reynolds (1986) analytic optical depth
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

def _mlr_shape_factor(a: float, r1: float, r2: float) -> float:
    """Closed-form cross-section integral shared by mlr<->n_0
    (physics.py:469-471)."""
    if a == -1.0 or a == -2.0:
        a = a * (1.0 + 1e-12)
    return ((r1 ** 2.0 + r2 * (r2 * (a + 1.0) - r1 * (a + 2.0)) *
             (r2 / r1) ** a) /
            ((r2 - r1) ** 2.0 * (a + 1.0) * (a + 2.0)))


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
