"""Free-free Gaunt factors of van Hoof et al. (2014): the 81x146 log-log
table with a Catmull-Rom bicubic interpolation on tensors, and its
companion uncertainty table looked up at the nearest node (PyTorch port of
rajepy_tpu.ops.gaunt).

The table is the port's own copy of the data file (``data/vanHoofetal2014.data``
in this package), byte-equal to the JAX package's.

Axes (reference physics.py:666-675):
    log g2 = log10(Z^2 * Ry_inf / (k_B T))   (column axis, 81 values)
    log u  = log10(h nu / (k_B T))           (row axis, 146 values)
"""
from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np
import torch

from .. import constants as cnsts

_DATA_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "vanHoofetal2014.data")

# Infinite-mass Rydberg energy [J] (physics.py:671-672)
_RY_INF = cnsts.M_E * cnsts.E_CHARGE ** 4 / (
    8.0 * cnsts.EPSILON_0 ** 2 * cnsts.H ** 2)


@lru_cache(maxsize=1)
def load_vanhoof_table():
    """Parse the bundled van Hoof et al. (2014) table once.

    Returns (loggam2_start, logu_start, step, gff[n_logu, n_loggam2]) as
    floats and a float64 numpy array (data file lines 30-41 hold the
    header layout).
    """
    with open(_DATA_FILE, "rt") as f:
        lines = f.readlines()
    loggam2_start = float(lines[30].split('#')[0])
    logu_start = float(lines[31].split('#')[0])
    step = float(lines[32].split('#')[0])
    n_gam2, n_u = (int(v) for v in lines[29].split('#')[0].split())
    data = np.array([[float(v) for v in ln.split()]
                     for ln in lines[42:42 + n_u]])
    if data.shape != (n_u, n_gam2):
        raise ValueError(f"van Hoof table has shape {data.shape}, header "
                         f"says {(n_u, n_gam2)}")
    return loggam2_start, logu_start, step, data


def _catmull_rom_weights(t):
    """Catmull-Rom cubic weights for the 4 support points around fraction t."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return w0, w1, w2, w3


def interp_bicubic(table: torch.Tensor, x0: float, y0: float, step: float,
                   x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Catmull-Rom bicubic interpolation of ``table[y_idx, x_idx]`` on the
    uniform grid starting at (x0, y0) with spacing ``step``.  Queries are
    clamped to the valid interior (the reference's index clamping,
    physics.py:683-690)."""
    ny, nx = table.shape
    fx = (x - x0) / step
    fy = (y - y0) / step
    ix = torch.floor(fx).long().clamp(1, nx - 3)
    iy = torch.floor(fy).long().clamp(1, ny - 3)
    tx = (fx - ix).clamp(-1.0, 2.0)
    ty = (fy - iy).clamp(-1.0, 2.0)

    wx = _catmull_rom_weights(tx)
    wy = _catmull_rom_weights(ty)

    out = 0.0
    for j in range(4):
        row = 0.0
        for i in range(4):
            row = row + wx[i] * table[iy + j - 1, ix + i - 1]
        out = out + wy[j] * row
    return out


def _log_axes(freq: torch.Tensor, temp, z: float):
    """(log g2, log u) of the table's axes at (freq, temp), broadcast, in
    float64 on ``freq``'s device."""
    dev = freq.device
    freq = freq.to(torch.float64)
    temp = torch.as_tensor(temp, dtype=torch.float64, device=dev)
    # log-sum form, not log-of-ratio (as the JAX module, for f32 safety)
    log_t = torch.log10(temp)
    logg2 = math.log10(z ** 2 * _RY_INF / cnsts.K_B) - log_t
    logu = math.log10(cnsts.H / cnsts.K_B) + torch.log10(freq) - log_t
    return torch.broadcast_tensors(logg2, logu)


def gff(freq: torch.Tensor, temp, z: float = 1.0) -> torch.Tensor:
    """Thermally averaged free-free Gaunt factor (physics.py:666-698).

    ``freq`` [Hz] is a tensor and ``temp`` [K] a tensor or a float; they
    broadcast.  Evaluated in float64 on ``freq``'s device and returned in
    float64, as the JAX version's table is float64.  Differentiable in a
    tensor ``temp`` (a fitted ``T_0``): the axes are formed as log sums
    (:func:`_log_axes`), which keeps a float32 caller's gradient from
    underflowing.
    """
    x0, y0, step, table = load_vanhoof_table()
    table = torch.as_tensor(table, dtype=torch.float64, device=freq.device)
    logg2, logu = _log_axes(freq, temp, z)
    return interp_bicubic(table, x0, y0, step, logg2, logu)


@lru_cache(maxsize=1)
def load_vanhoof_uncertainties():
    """Parse the table's companion uncertainty block (same layout, data
    file lines 193+; the reference reads it at physics.py:640-641 via
    ``import_vanHoof2014(errors=True)``)."""
    with open(_DATA_FILE, "rt") as f:
        lines = f.readlines()
    n_gam2, n_u = (int(v) for v in lines[29].split('#')[0].split())
    unc = np.array([[float(v) for v in ln.split()]
                    for ln in lines[192:192 + n_u]])
    if unc.shape != (n_u, n_gam2):
        raise ValueError(f"van Hoof uncertainty table has shape "
                         f"{unc.shape}, header says {(n_u, n_gam2)}")
    return unc


def gff_uncertainty(freq: torch.Tensor, temp, z: float = 1.0
                    ) -> torch.Tensor:
    """1-sigma uncertainty of the van Hoof et al. (2014) Gaunt factor at
    the query point (nearest-node lookup of the companion uncertainty
    table — the published uncertainties are themselves node estimates,
    so interpolating them adds nothing).  Float64 on ``freq``'s device."""
    x0, y0, step, _ = load_vanhoof_table()
    unc = torch.as_tensor(load_vanhoof_uncertainties(), dtype=torch.float64,
                          device=freq.device)
    ny, nx = unc.shape
    logg2, logu = _log_axes(freq, temp, z)
    # round half to even, as jnp.round
    ix = torch.round((logg2 - x0) / step).long().clamp(0, nx - 1)
    iy = torch.round((logu - y0) / step).long().clamp(0, ny - 1)
    return unc[iy, ix]


def gff_with_uncertainty(freq: torch.Tensor, temp, z: float = 1.0):
    """(gff, sigma_gff): the reference's value-with-uncertainty form of
    the van Hoof table (physics.py:659, ``uf(gff, unc_lines...)``) as a
    plain tensor pair; a relative gaunt error propagates one-to-one into
    tau_ff and the optically-thin flux."""
    return gff(freq, temp, z), gff_uncertainty(freq, temp, z)
