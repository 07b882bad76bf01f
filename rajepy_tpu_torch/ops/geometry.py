"""Jet geometry on tensors (PyTorch port of rajepy_tpu.ops.geometry).

Implements the Reynolds (1986) + disc-wind jet geometry of the reference
RaJePy (maths/geometry.py) as branch-free tensor programs:

* ``mod_r_0``           — geometry.py:12-31
* ``rho``               — geometry.py:34-61
* ``cell_value``        — geometry.py:64-93
* ``w_r``               — geometry.py:96-118
* ``xyz_rotate``        — geometry.py:212-263
* ``cartesian_to_cylindrical`` — geometry.py:266-302
* ``xyz_to_rwp``        — geometry.py:181-209
* ``r_eff``             — geometry.py:305-336
* ``t_rw``              — geometry.py:121-178 (travel time through the
  combined Pfaff-transformed ₂F₁ series of :mod:`.hyp2f1`)

Angles are in degrees.  A Python float's cosine and sine are taken in
double precision on the host and applied to the tensors in the tensors'
dtype, as JAX does with its weakly typed scalars; a 0-d tensor (a fitted
parameter, :mod:`rajepy_tpu_torch.fit`) takes torch's functions, so its
gradient flows.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .hyp2f1 import hyp2f1_a1_series


def _cos_sin_deg(deg):
    if isinstance(deg, torch.Tensor):
        rad = torch.deg2rad(deg)
        return torch.cos(rad), torch.sin(rad)
    rad = math.radians(deg)
    return math.cos(rad), math.sin(rad)


def mod_r_0(opang_deg, epsilon, w_0):
    """Modified launching radius: radius at which a Reynolds (1986) jet of
    half-width ``w_0`` maintains opening angle ``opang`` (geometry.py:12-31).
    Returned in the units of ``w_0``."""
    if isinstance(opang_deg, torch.Tensor):
        return epsilon * w_0 / torch.tan(torch.deg2rad(opang_deg) / 2.0)
    return epsilon * w_0 / math.tan(math.radians(opang_deg) / 2.0)


def rho(r, r_0, mr0=None):
    """Distance along the jet axis in units of (modified) launching radius
    (geometry.py:34-61).  With ``mr0`` given, r is translated by
    ``mr0 - r_0`` and normalised by ``mr0``."""
    r = abs(r)
    if mr0 is None:
        return r / r_0
    # 1 + (r - r_0)/mr0 rather than the JAX module's (r + mr0 - r_0)/mr0:
    # the same value to an ulp, but exactly 1 on the launch surface.  There
    # the corner test compares w_0 * rho^eps with w = w_0 exactly, and
    # rho = 1 + ulp would leave the answer to the last bit of pow, which
    # PyTorch's vectorised and scalar CPU loops round differently.
    return 1.0 + (r - r_0) / mr0


def cell_value(zero_val, rho_, r_eff_, r1, q, qd):
    """Power-law cell value ``zero_val * rho^q * (r_eff/r1)^qd``
    (geometry.py:64-93)."""
    return zero_val * rho_ ** q * (r_eff_ / r1) ** qd


def w_r(r, w_0, mr0, r_0, eps):
    """Jet half-width w(r) (geometry.py:96-118)."""
    return w_0 * rho(r, r_0, mr0) ** eps


def _rot_x(x, y, z, cos_a, sin_a):
    """Right-handed rotation about the x-axis."""
    return x, cos_a * y - sin_a * z, sin_a * y + cos_a * z


def _rot_y(x, y, z, cos_b, sin_b):
    """Right-handed rotation about the y-axis."""
    return cos_b * x + sin_b * z, y, cos_b * z - sin_b * x


def xyz_rotate(x, y, z, alpha_deg, beta_deg, order: str = "xy"):
    """Compose x-axis (by ``alpha``) and y-axis (by ``beta``) rotations in the
    given ``order`` ('xy' or 'yx'), angles in degrees
    (geometry.py:212-263)."""
    cos_a, sin_a = _cos_sin_deg(alpha_deg)
    cos_b, sin_b = _cos_sin_deg(beta_deg)
    if order.lower() == "xy":
        return _rot_y(*_rot_x(x, y, z, cos_a, sin_a), cos_b, sin_b)
    if order.lower() == "yx":
        return _rot_x(*_rot_y(x, y, z, cos_b, sin_b), cos_a, sin_a)
    raise ValueError(f"rotation order {order!r} not recognised")


def cartesian_to_cylindrical(x, y, z):
    """(x, y, z) -> (rho, phi, z) with the reference's arcsin+quadrant-fix
    convention (geometry.py:266-302).  phi in radians."""
    rho_ = torch.sqrt(x * x + y * y)
    phi_ = torch.asin(y / rho_)
    phi_ = torch.where(x < 0, -phi_ + math.pi, phi_)
    return rho_, phi_, z


def xyz_to_rwp(x, y, z, inc_deg, pa_deg) -> Tuple[torch.Tensor,
                                                  torch.Tensor,
                                                  torch.Tensor]:
    """Observer-frame (x, y, z) -> jet-frame (r, w, phi)
    (geometry.py:181-209): derotate by (inc - 90, pa) in 'yx' order, then go
    cylindrical; the cylindrical z is the jet's r axis."""
    xd, yd, zd = xyz_rotate(x, y, z, inc_deg - 90.0, pa_deg, order="yx")
    w, p, r = cartesian_to_cylindrical(xd, yd, zd)
    return r, w, p


def r_eff(w, r_1, r_2, w_0, r, mr0, r_0, eps):
    """Disc radius from which material at jet coordinates (w, r) was launched
    (geometry.py:305-336)."""
    return r_1 + ((r_2 - r_1) * w) / w_r(r, w_0, mr0, r_0, eps)


def t_rw(r_au, w_au, *, w_0, r_0, v_0, mr0, eps, r_1, r_2, q_v, q_vd,
         max_terms: int = 4096, rtol: float = 1e-14):
    """Travel time (years) of material from launch to jet coordinate (r, w).

    Closed form of the reference's geometry.py:121-178 (SI inside):

        t(r, w) = I(|r|, w) - I(r_0, w),
        I(r_, w_) = C * rad^(1-q_v) * (r_eff/r_1)^(-q_vd) * P(r_, w_)

    with ``rad = r_ + mr0 - r_0``, ``C = mr0^q_v / (v_0 (1 - q_v + eps
    q_vd))`` and ``P = 2F1(q_vd, 1; b+1; u)``, ``u = z/(z-1)``,
    ``z = r_1 w_0 rad^eps / (w_ mr0^eps (r_1 - r_2))`` and
    ``b = (1 - q_v + eps*q_vd)/eps``.  At w == 0 the reference substitutes
    P = 1 + q_vd/(1 - q_v) (geometry.py:159-164); reproduced exactly.

    ``r_au``/``w_au`` are broadcastable tensors in au; the other parameters
    are Python floats or 0-d tensors (fitted parameters; a gradient through
    the series itself is refused, see :func:`.hyp2f1.hyp2f1_a1_series`).
    Returns time in **years**.
    """
    AU = 149597870700.0
    YEAR = 31536000.0

    w0_m = w_0 * AU
    r0_m = r_0 * AU
    v0_m = v_0 * 1e3
    mr0_m = mr0 * AU
    r1_m = r_1 * AU
    r2_m = r_2 * AU

    a = q_vd
    b = (1.0 - q_v + eps * q_vd) / eps
    const = mr0_m ** q_v / (v0_m * (1.0 - q_v + eps * q_vd))

    r_m = r_au.abs() * AU
    w_m = w_au * AU
    w_zero = w_m == 0.0

    def indef_m(r_):
        rad = r_ + mr0_m - r0_m
        p1 = rad ** (1.0 - q_v)
        wr = w0_m * (rad / mr0_m) ** eps
        reff = r1_m + (r2_m - r1_m) * w_m / wr
        p2 = (reff / r1_m) ** (-q_vd)
        denom = torch.where(w_zero, torch.ones_like(w_m),
                            w_m * mr0_m ** eps * (r1_m - r2_m))
        z = (r1_m * w0_m * rad ** eps) / denom
        z = torch.where(w_zero, torch.zeros_like(z), z)
        u = z / (z - 1.0)
        p34 = hyp2f1_a1_series(a, b + 1.0, u, max_terms=max_terms, rtol=rtol)
        p34_w0 = 1.0 + q_vd / (1.0 - q_v)
        if not isinstance(p34_w0, torch.Tensor):
            p34_w0 = torch.full_like(p34, p34_w0)
        p34 = torch.where(w_zero, p34_w0, p34)
        return const * p1 * p2 * p34

    return (indef_m(r_m) - indef_m(torch.full_like(r_m, r0_m))) / YEAR
