"""The work of K2, the epoch maps of a continuum run: sum over the line of
sight of a * chi(t)^2 and of em * chi(t)^2 (chi the burst factor at the
run's epoch), counted from the configuration's own jet.  Only jet cells
contribute (a and em are zero elsewhere), so the least the card must do is
read a, em and the launch time of every jet cell once (float32), write the
two (nx, nz) maps once, and per jet cell evaluate its side's bursts."""
from __future__ import annotations

from typing import Tuple

import torch

from ..reference.jet import Jet

BYTES = 4                     # float32
OPS_CELL = 6                  # t - ts, chi^2, two multiply-adds
OPS_BURST = 6                 # subtract, square, scale, exp, multiply-add


def jet_cells(jet: Jet, device) -> Tuple[int, int]:
    """(red-side, blue-side) jet cells of the float64 fill."""
    red = blue = 0
    for x0 in range(0, jet.nx, jet.rows()):
        s = jet.slab(x0, min(jet.nx, x0 + jet.rows()), torch.float64, device)
        red += int((s['inside'] & s['red']).sum())
        blue += int((s['inside'] & ~s['red']).sum())
    return red, blue


def k2(params, device) -> Tuple[float, float]:
    """(bytes, float32 operations) of one run's epoch maps."""
    jet = Jet(params)
    red, blue = jet_cells(jet, device)
    n_red = sum(1 for b in jet.bursts if b[3])
    n_blue = len(jet.bursts) - n_red
    n_bytes = 3 * BYTES * (red + blue) + 2 * BYTES * jet.nx * jet.nz
    ops = (red * (OPS_CELL + OPS_BURST * n_red) +
           blue * (OPS_CELL + OPS_BURST * n_blue))
    return float(n_bytes), float(ops)
