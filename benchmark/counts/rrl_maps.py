"""The work of K4, the RRL line-opacity maps of a line run:
tau(c, x, z) = sum_y amp Re w(x_c + i y) (1 - exp(-h nu_c / k T)), counted
from the configuration's own jet at the run's epoch.  The least the card
must do: read each jet cell's temperature, density, LOS velocity and path
length once (float32), the channels once, write the (n_chan, nx, nz) maps
once; and per jet cell and channel the common part plus the Voigt core
(|x| + y <= 8, a 16-term rational) or wings (a 3-term series), counted as
PERF.md's kernel table counts them (a division or an exp as one operation,
a multiply-add as two)."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..reference import constants as k
from ..reference.jet import Jet, Line

BYTES = 4
OPS_COMMON, OPS_CORE, OPS_FAR = 10, 98, 33
FAR = 8.0


def k4(params, line: str, freqs: Sequence[float], epoch: float, device,
       chan_block: int = 64) -> Tuple[float, float]:
    """(bytes, float32 operations) of one run's line-opacity maps."""
    jet, ln = Jet(params), Line(line)
    d_f = torch.as_tensor([f - ln.nu0 for f in freqs], dtype=torch.float64,
                          device=device)
    cells = n_far = 0
    for x0 in range(0, jet.nx, jet.rows()):
        s = jet.slab(x0, min(jet.nx, x0 + jet.rows()), torch.float64, device)
        ins = s['inside']
        n_e = (s['nd'] * jet.chi(s['red'], epoch - s['ts']) * s['xi'])[ins]
        temp, vy = s['temp'][ins], s['vy'][ins]
        cells += int(ins.sum())
        d_rest = -ln.nu0 * vy * 1e3 / k.C
        fwhm_g = torch.sqrt(8.0 * k.LN2 * k.K_B * temp /
                            (ln.mass * k.C ** 2)) * (ln.nu0 + d_rest)
        scale = 2.0 * math.sqrt(k.LN2) / fwhm_g
        y = 0.5 * 8.2 * n_e * (ln.n / 100.0) ** 4.5 * \
            (1.0 + 2.25 * ln.dn / ln.n) * scale
        for c0 in range(0, len(d_f), chan_block):
            x = (d_f[c0:c0 + chan_block, None] - d_rest[None]) * scale[None]
            n_far += int((x.abs() + y[None] > FAR).sum())
    pairs = cells * len(d_f)
    n_bytes = (4 * BYTES * cells + BYTES * len(d_f) +
               BYTES * len(d_f) * jet.nx * jet.nz)
    ops = (pairs * OPS_COMMON + (pairs - n_far) * OPS_CORE +
           n_far * OPS_FAR)
    return float(n_bytes), float(ops)
