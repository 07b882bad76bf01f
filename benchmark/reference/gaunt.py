"""Thermally averaged free-free Gaunt factor of van Hoof et al. (2014, MNRAS
444, 420): their published table (``vanHoofetal2014.data`` beside this
file, unaltered), read by its header and interpolated with Catmull-Rom
cubics along both log axes, the upstream RaJePy's scheme."""
from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np
import torch

from . import constants as k

_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'vanHoofetal2014.data')


@lru_cache(maxsize=1)
def table():
    """(log gamma^2 start, log u start, step, gff[n_u, n_gamma2])."""
    with open(_TABLE) as f:
        rows = [ln.split('#')[0].split() for ln in f]
    rows = [r for r in rows if r]
    n_g2, n_u = (int(v) for v in rows[1])
    g2_0, u_0, step = (float(rows[i][0]) for i in (2, 3, 4))
    data = np.array(rows[5:5 + n_u], dtype=np.float64)
    if data.shape != (n_u, n_g2):
        raise ValueError(f"van Hoof table {data.shape}, header {(n_u, n_g2)}")
    return g2_0, u_0, step, data


def _weights(t):
    t2, t3 = t * t, t * t * t
    return (-0.5 * t3 + t2 - 0.5 * t, 1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t, 0.5 * t3 - 0.5 * t2)


def gff(freq: torch.Tensor, temp, z: int = 1) -> torch.Tensor:
    """g_ff(freq [Hz], temp [K]) in ``freq``'s dtype; ``temp`` a float or a
    tensor (differentiable)."""
    g2_0, u_0, step, data = table()
    tab = torch.as_tensor(data, dtype=freq.dtype, device=freq.device)
    temp = torch.as_tensor(temp, dtype=freq.dtype, device=freq.device)
    log_t = torch.log10(temp)
    log_g2 = math.log10(z ** 2 * k.RY_INF / k.K_B) - log_t
    log_u = math.log10(k.H / k.K_B) + torch.log10(freq) - log_t
    log_g2, log_u = torch.broadcast_tensors(log_g2, log_u)
    fx, fy = (log_g2 - g2_0) / step, (log_u - u_0) / step
    n_u, n_g2 = tab.shape
    ix = torch.floor(fx).long().clamp(1, n_g2 - 3)
    iy = torch.floor(fy).long().clamp(1, n_u - 3)
    wx = _weights((fx - ix).clamp(-1.0, 2.0))
    wy = _weights((fy - iy).clamp(-1.0, 2.0))
    out = 0.0
    for j in range(4):
        out = out + wy[j] * sum(wx[i] * tab[iy + j - 1, ix + i - 1]
                                for i in range(4))
    return out
