"""Faddeeva function and Voigt profile on tensors (PyTorch port of
rajepy_tpu.ops.voigt).

``w(z)`` for the upper half-plane is built, as in the JAX package, from:

* the Weideman (1994, SIAM J. Numer. Anal. 31, 1497) rational
  approximation of degree N (coefficients computed on the host with a
  numpy FFT, :func:`_weideman_coeffs`);
* a Laplace continued fraction for ``|x| + y`` beyond the rational
  region, which avoids the rational form's cancellation near the real
  axis at large |x|;
* (float64 only) a third-order Taylor expansion from the real axis for
  ``y < 3e-5``, where ``Re w(x) = exp(-x**2)`` is exact.

float64 uses Weideman-128 with a 15-level fraction beyond |x| + y = 9;
float32 uses Weideman-32 with a 9-level fraction beyond 8.  Complex
arithmetic is written out in (re, im) pairs, like the JAX code, so both
packages evaluate the same operations in the same order.

:func:`wofz` is a ``torch.autograd.Function`` whose derivative comes from
the Faddeeva ODE ``w'(z) = -2 z w + 2i/sqrt(pi)`` on the computed value
(the JAX package's custom JVP, voigt.py:171-184): differentiating through
the 128-term Horner recurrence would cost ~100x the forward.  It has a
``backward`` (reverse mode) and a ``jvp`` (forward mode).

The value on CUDA tensors comes from one hand-written kernel
(``csrc/voigt.cu``, :func:`ops.kernels.wofz_kernel`), the same scheme
with the same rounding; on CPU tensors from the eager scheme below, its
plain version (:func:`_wofz_plain`).  The counters ``voigt.wofz_evals``
(every evaluation) and ``voigt.wofz_kernel`` (those through the kernel)
of ``utils.profiling`` say how often the kernel serves.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..utils import profiling

_SQRT_PI = 1.7724538509055159
_N_WEIDEMAN = 128          # float64 rational degree (roundoff-floor accurate)
_CF_LEVELS_F64 = 15        # float64 continued-fraction depth
_CF_LEVELS_F32 = 9
_Y_TAYLOR_F64 = 3e-5       # below this, Taylor from the exact real-axis value


@lru_cache(maxsize=4)
def _weideman_coeffs(n: int = _N_WEIDEMAN):
    """Host-side FFT computation of the Weideman (1994) expansion
    coefficients (highest power first) and scale L."""
    m = 2 * n
    m2 = 2 * m
    ell = np.sqrt(n / np.sqrt(2.0))
    k = np.arange(-m + 1, m)
    theta = k * np.pi / m
    t = ell * np.tan(theta / 2.0)
    f = np.exp(-t ** 2) * (ell ** 2 + t ** 2)
    f = np.append(0.0, f)
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / m2
    a = np.flipud(a[1:n + 1])
    return ell, a


def _wofz_core(x, y, n_weideman, cf_levels, s_cut):
    """Weideman-rational (interior) / continued-fraction (wings) composite
    for tensors ``x``, ``y >= 0`` of one float dtype.  Branch-free."""
    ell, a_np = _weideman_coeffs(n_weideman)
    a = [float(v) for v in a_np]
    zero = torch.zeros_like(x)

    s = x.abs() + y
    far = s > s_cut

    # ---- Weideman: Z = (L + iz)/(L - iz) with z = x + iy ------------------
    # Far entries are evaluated at a harmless interior point so the
    # rational form stays pole-free where its result is discarded.
    xi = torch.where(far, zero, x)
    yi = torch.where(far, torch.zeros_like(y), y)
    dr, di = ell + yi, -xi
    nr, ni = ell - yi, xi
    den = dr * dr + di * di
    zr = (nr * dr + ni * di) / den
    zi = (ni * dr - nr * di) / den

    # Horner evaluation of p(Z) = sum a_k Z^k (a in descending order)
    pr = zero + a[0]
    pi = torch.zeros_like(zr)
    for k in range(1, len(a)):
        pr, pi = pr * zr - pi * zi + a[k], pr * zi + pi * zr

    # w = 2 p / (L - iz)^2 + (1/sqrt(pi)) / (L - iz)
    inv_r, inv_i = dr / den, -di / den
    inv2_r = inv_r * inv_r - inv_i * inv_i
    inv2_i = 2.0 * inv_r * inv_i
    w_re = 2.0 * (pr * inv2_r - pi * inv2_i) + inv_r / _SQRT_PI
    w_im = 2.0 * (pr * inv2_i + pi * inv2_r) + inv_i / _SQRT_PI

    # ---- far wings: Laplace continued fraction ----------------------------
    # w(z) = (i/sqrt(pi)) / (z - (1/2)/(z - 1/(z - (3/2)/(z - ...))))
    xf = torch.where(far, x, torch.full_like(x, 10.0))
    yf = torch.where(far, y, torch.full_like(y, 10.0))
    rr = torch.zeros_like(xf)
    ri = torch.zeros_like(xf)
    for k in range(cf_levels, 0, -1):
        den_r = xf - rr
        den_i = yf - ri
        den = den_r * den_r + den_i * den_i
        rr = (k / 2.0) * den_r / den
        ri = -(k / 2.0) * den_i / den
    den_r = xf - rr
    den_i = yf - ri
    den = den_r * den_r + den_i * den_i
    asym_re = den_i / (den * _SQRT_PI)
    asym_im = den_r / (den * _SQRT_PI)

    return torch.where(far, asym_re, w_re), torch.where(far, asym_im, w_im)


def wofz(x, y):
    """Faddeeva function ``w(x + iy)`` for ``y >= 0``; returns ``(re, im)``.

    The scheme follows the dtype, as rajepy_tpu.ops.voigt.wofz:

    * **float64** — Weideman N=128 interior, 15-level continued fraction
      for ``|x| + y > 9``, and a third-order Taylor expansion from the
      real axis for ``y < 3e-5``;
    * **float32** — Weideman N=32 / 9-level fraction.

    Differentiable in ``x`` and ``y`` through the Faddeeva ODE
    (:class:`_Wofz`).
    """
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    dtype = torch.promote_types(x.dtype, y.dtype)
    if not dtype.is_floating_point:
        dtype = torch.get_default_dtype()
    x, y = torch.broadcast_tensors(x.to(dtype), y.to(dtype))
    return _Wofz.apply(x, y)


def _w_prime(x, y, wr, wi):
    """``(Re w', Im w')`` at z = x + iy from w there: the Faddeeva ODE
    w' = -2 z w + 2i/sqrt(pi)."""
    dpr = -2.0 * (x * wr - y * wi)
    dpi = -2.0 * (x * wi + y * wr) + 2.0 / _SQRT_PI
    return dpr, dpi


class _Wofz(torch.autograd.Function):
    """``w(x + iy)`` on broadcast tensors of one float dtype, with
    d/dx w = w' and d/dy w = i w' (w analytic)."""

    @staticmethod
    def forward(x, y):
        return _wofz_eval(x, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, *output)
        ctx.save_for_forward(*inputs, *output)

    @staticmethod
    def backward(ctx, g_re, g_im):
        dpr, dpi = _w_prime(*ctx.saved_tensors)
        return g_re * dpr + g_im * dpi, g_im * dpr - g_re * dpi

    @staticmethod
    def jvp(ctx, dx, dy):
        dpr, dpi = _w_prime(*ctx.saved_tensors)
        if dx is None:
            dx = torch.zeros_like(dpr)
        if dy is None:
            dy = torch.zeros_like(dpr)
        return dpr * dx - dpi * dy, dpi * dx + dpr * dy


def _wofz_eval(x, y):
    """The value of :func:`wofz` on broadcast tensors of one dtype: the
    CUDA kernel for CUDA tensors, the plain version otherwise."""
    profiling.count('voigt.wofz_evals')
    if x.is_cuda:
        from .kernels import wofz_kernel    # kernels imports this module
        out = wofz_kernel(x, y)
        profiling.count('voigt.wofz_kernel')
        return out
    return _wofz_plain(x, y)


def _wofz_plain(x, y):
    """The plain version of the value of :func:`wofz`: one eager operation
    per term, on broadcast tensors of one dtype."""
    dtype = x.dtype
    if dtype == torch.float32:
        return _wofz_core(x, y, 32, _CF_LEVELS_F32, 8.0)

    tiny = y < _Y_TAYLOR_F64
    y_eff = torch.where(tiny, torch.zeros_like(y), y)
    w_re, w_im = _wofz_core(x, y_eff, _N_WEIDEMAN, _CF_LEVELS_F64, 9.0)

    # Small-y branch: Re w on the axis is exp(-x^2) exactly (the
    # composite's Re has an absolute roundoff floor ~1e-15); Taylor both
    # parts up to y^3 from w' = -2 z w + 2i/sqrt(pi).
    w0r = torch.exp(-x * x)
    w0i = w_im
    d1r = -2.0 * x * w0r
    d1i = -2.0 * x * w0i + 2.0 / _SQRT_PI
    d2r = -2.0 * w0r - 2.0 * x * d1r
    d2i = -2.0 * w0i - 2.0 * x * d1i
    d3r = -4.0 * d1r - 2.0 * x * d2r
    d3i = -4.0 * d1i - 2.0 * x * d2i
    y2 = y * y
    taylor_re = w0r - y * d1i - 0.5 * y2 * d2r + (y2 * y / 6.0) * d3i
    taylor_im = w0i + y * d1r - 0.5 * y2 * d2i - (y2 * y / 6.0) * d3r

    return (torch.where(tiny, taylor_re, w_re),
            torch.where(tiny, taylor_im, w_im))


def voigt_profile(dnu, fwhm_gauss, fwhm_lorentz):
    """Area-normalised Voigt profile ``phi_V(nu0 + dnu)`` [Hz^-1]
    (voigt.py:185; the reference's ``phi_voigt_nu``, rrls.py:329-359):
    ``Re w((dnu + i G/2) / (sigma sqrt 2)) / (sigma sqrt(2 pi))`` with
    ``sigma = fwhm_gauss / (2 sqrt(2 ln 2))`` and ``G = fwhm_lorentz``."""
    sigma = fwhm_gauss / (2.0 * math.sqrt(2.0 * math.log(2.0)))
    scale = 1.0 / (sigma * math.sqrt(2.0))
    x = dnu * scale
    y = 0.5 * fwhm_lorentz * scale
    re, _ = wofz(x, y)
    return re / (sigma * math.sqrt(2.0 * math.pi))
