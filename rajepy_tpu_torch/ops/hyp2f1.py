"""Gauss hypergeometric series for the jet travel-time integral (PyTorch
port of rajepy_tpu.ops.hyp2f1).

The travel-time integrand needs ``(1 - z)^a * 2F1(a, b; b+1; z)`` with
``z <= 0``.  The Pfaff transformation collapses that product to
``2F1(a, 1; b+1; u)`` with ``u = z/(z-1) in [0, 1)`` — a Gauss series with
unit numerator parameter,

    2F1(a, 1; c; u) = sum_n [(a)_n / (c)_n] u^n,

summed directly for u <= 0.8 and re-expanded about u = 1 with the DLMF
15.8.4 connection formula above (see the JAX module for the derivation).

The JAX version runs the series in a ``lax.while_loop``; here it is a
Python loop over whole-grid tensors that checks convergence every
``_CHUNK`` terms with one ``.item()``.  With the dtype-resolution floor on
``rtol`` an f32 series at u <= 0.8 stops after about ten chunks, so the
loop costs a handful of host syncs per grid fill and needs no kernel.

Derivatives.  ``c`` may be a 0-d tensor (it follows the fitted
``geometry.epsilon`` and ``power_laws.q_v``).  At ``a == 0`` the series is
the constant 1 and needs no derivative.  Otherwise a derivative through the
series in ``u`` or ``c`` is refused with a ``ValueError``: reverse mode would
keep every term of the data-dependent loop (thousands of grid-sized
tensors).  The JAX package refuses the same case: its ``lax.while_loop``
has no reverse-mode derivative (``ValueError``), and a traced ``c`` fails
its ``float(c)`` (``ConcretizationTypeError``) whatever ``a`` is.
"""
from __future__ import annotations

import math

import torch
from torch.autograd import forward_ad

_CHUNK = 8        # series terms accumulated between convergence checks
_SWITCH = 0.8     # u above which the 1-u re-expansion is used


def _gauss_series_b1(a: float, c: float, u: torch.Tensor, max_terms: int,
                     rtol: float) -> torch.Tensor:
    """sum_n (a)_n/(c)_n u^n elementwise for u in [0, _SWITCH].

    Accumulates ``_CHUNK`` terms per pass and stops once every cell's
    current term is below ``rtol`` of its partial sum; a geometric tail
    estimate ``t_N * r/(1-r)`` is added on exit.
    """
    # convergence threshold cannot be finer than the dtype resolution
    # (an f32 series would otherwise always run to max_terms)
    rtol = max(rtol, 4.0 * torch.finfo(u.dtype).eps)
    acc = torch.ones_like(u)
    term = torch.ones_like(u)
    n = 0
    while n < max_terms:
        max_rel = (term.abs() / acc.abs().clamp_min(1.0)).max().item()
        if not max_rel > rtol:
            break
        for k in range(_CHUNK):
            term = term * ((a + (n + k)) / (c + (n + k)) * u)
            acc = acc + term
        n += _CHUNK

    r = (a + n) / (c + n) * u
    tail = torch.where(r.abs() < 1.0, term * r / (1.0 - r),
                       torch.zeros_like(r))
    return acc + tail


def _carries_derivative(t) -> bool:
    """Whether ``t`` is a tensor that autograd would differentiate, in
    reverse mode (``requires_grad``) or in forward mode (a dual tensor)."""
    if not isinstance(t, torch.Tensor):
        return False
    return t.requires_grad or forward_ad.unpack_dual(t).tangent is not None


def hyp2f1_a1_series(a: float, c, u: torch.Tensor, *,
                     max_terms: int = 8192,
                     rtol: float = 1e-15) -> torch.Tensor:
    """Evaluate ``2F1(a, 1; c; u)`` elementwise for ``0 <= u < 1``.

    ``a`` is a Python float and ``c`` a Python float or a 0-d tensor (model
    power-law exponents); ``u`` is a tensor.  Uses the direct Gauss series
    for u <= 0.8 and the u -> 1-u connection formula above 0.8.  Raises
    ``ValueError`` where ``a != 0`` and ``u`` or ``c`` carries a
    derivative (module docstring).
    """
    a = float(a)

    if a == 0.0:
        return torch.ones_like(u)
    if _carries_derivative(u) or _carries_derivative(c):
        raise ValueError(
            "no derivative through the 2F1 travel-time series (q^d_v = "
            f"{a:g} != 0): free no parameter that moves the travel times "
            "(geometry.inc/pa/opang/epsilon, power_laws.q_v) on a model "
            "with bursts, or set q^d_v = 0")
    c = float(c)

    if a < 0.0 and a == round(a):
        # Terminating series (polynomial of degree -a): exact for all u
        return _gauss_series_b1(a, c, u, max_terms, rtol)

    # Nudge away from the degenerate case where c - a - 1 is an integer
    # (gamma poles in A/B; the log-case connection formula would be needed).
    s = c - a - 1.0
    if abs(s - round(s)) < 1e-5:
        a = a + 1e-9 if s >= round(s) else a - 1e-9
        s = c - a - 1.0

    # --- branch 1: direct series, u clamped into its fast-convergence zone
    u_lo = u.clamp_max(_SWITCH)
    f_series = _gauss_series_b1(a, c, u_lo, max_terms, rtol)

    # --- branch 2: re-expansion about u = 1 (v = 1 - u small)
    coef_a = (math.gamma(c) * math.gamma(s)) / (math.gamma(c - a) *
                                                math.gamma(c - 1.0))
    coef_b = (math.gamma(c) * math.gamma(-s)) / math.gamma(a)
    hi = u > _SWITCH
    v = torch.where(hi, 1.0 - u, torch.full_like(u, 1.0 - _SWITCH))
    u_hi = torch.where(hi, u, torch.ones_like(u))
    f_conn = (coef_a * _gauss_series_b1(a, a + 2.0 - c, v, max_terms, rtol)
              + coef_b * v ** s * u_hi ** (1.0 - c))

    return torch.where(hi, f_conn, f_series)


def hyp2f1_pfaff_product(a: float, b: float, z: torch.Tensor, *,
                         max_terms: int = 8192,
                         rtol: float = 1e-15) -> torch.Tensor:
    """``(1 - z)^a * 2F1(a, b; b+1; z)`` for ``z <= 0`` — the exact factor
    ``p3 * p4`` of the reference's travel-time integrand (geometry.py:165-171,
    where p3 = (1-z)^q_vd and p4 = hyp2f1(q_vd, b, b+1, z))."""
    u = z / (z - 1.0)
    return hyp2f1_a1_series(a, b + 1.0, u, max_terms=max_terms, rtol=rtol)
