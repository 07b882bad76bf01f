"""The Faddeeva function w(z) = exp(-z^2) erfc(-iz) for Im z >= 0, in plain
PyTorch real arithmetic (pairs of real tensors, so that it runs in any float
dtype, bfloat16 included).

Two published schemes, chosen by |x| + y:

* inside, Weideman (1994, SIAM J. Numer. Anal. 31, 1497), the rational
  series in Z = (L + iz)/(L - iz) of degree ``N_WEIDEMAN``;
* outside, the Laplace continued fraction
  w(z) = (i/sqrt(pi)) / (z - (1/2)/(z - 1/(z - (3/2)/(z - ...)))).

``re_w`` is differentiable through the Faddeeva equation
w'(z) = -2 z w + 2i/sqrt(pi).  ``tests/test_bench_reference.py`` holds the
float64 values against ``scipy.special.wofz``.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

SQRT_PI = math.sqrt(math.pi)
N_WEIDEMAN = 64
CF_LEVELS = 40
FAR = 12.0


@lru_cache(maxsize=None)
def _weideman_coeffs(n: int):
    """Weideman's scale L and the coefficients a_1..a_n, highest power of Z
    first (his Table 1 recipe, by an FFT)."""
    m = 2 * n
    ell = math.sqrt(n / math.sqrt(2.0))
    theta = np.arange(-m + 1, m) * np.pi / m
    t = ell * np.tan(theta / 2.0)
    f = np.concatenate([[0.0], np.exp(-t ** 2) * (ell ** 2 + t ** 2)])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2 * m)
    return ell, tuple(float(v) for v in a[1:n + 1][::-1])


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def wofz(x: torch.Tensor, y: torch.Tensor):
    """(Re w, Im w) at x + iy, y >= 0, in the dtype of ``x``."""
    far = (x.abs() + y) > FAR
    # each scheme is evaluated where it is not used at a harmless point
    xi = torch.where(far, torch.zeros_like(x), x)
    yi = torch.where(far, torch.zeros_like(y), y)
    ell, a = _weideman_coeffs(N_WEIDEMAN)
    # L - iz = (L + y) - i x ; L + iz = (L - y) + i x
    dr, di = ell + yi, -xi
    zr, zi = _cdiv(ell - yi, xi, dr, di)
    pr = torch.full_like(zr, a[0])
    pi = torch.zeros_like(zr)
    for ak in a[1:]:
        pr, pi = pr * zr - pi * zi + ak, pr * zi + pi * zr
    ir, ii = _cdiv(torch.ones_like(dr), torch.zeros_like(di), dr, di)
    i2r, i2i = ir * ir - ii * ii, 2.0 * ir * ii
    in_r = 2.0 * (pr * i2r - pi * i2i) + ir / SQRT_PI
    in_i = 2.0 * (pr * i2i + pi * i2r) + ii / SQRT_PI

    xf = torch.where(far, x, torch.full_like(x, 2.0 * FAR))
    yf = torch.where(far, y, torch.full_like(y, 2.0 * FAR))
    rr = torch.zeros_like(xf)
    ri = torch.zeros_like(xf)
    for k in range(CF_LEVELS, 0, -1):
        rr, ri = _cdiv(torch.full_like(xf, k / 2.0), torch.zeros_like(xf),
                       xf - rr, yf - ri)
    qr, qi = _cdiv(torch.zeros_like(xf), torch.full_like(xf, 1.0 / SQRT_PI),
                   xf - rr, yf - ri)
    return torch.where(far, qr, in_r), torch.where(far, qi, in_i)


class _ReW(torch.autograd.Function):
    """Re w(x + iy) with d/dx = Re w', d/dy = -Im w'."""

    @staticmethod
    def forward(ctx, x, y):
        wr, wi = wofz(x, y)
        ctx.save_for_backward(x, y, wr, wi)
        return wr

    @staticmethod
    def backward(ctx, g):
        x, y, wr, wi = ctx.saved_tensors
        dr = -2.0 * (x * wr - y * wi)
        di = -2.0 * (x * wi + y * wr) + 2.0 / SQRT_PI
        return g * dr, -g * di


def re_w(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Re w(x + iy), the Voigt function, differentiable in x and y."""
    x, y = torch.broadcast_tensors(x, y)
    return _ReW.apply(x, y)
