"""The least work of a line cube's CLEAN: Hogbom's minor cycle on every
channel, counted from the cell's own image geometry (the image's size and
the CLEAN mask of the reference's plan) and the channel-iterations the
run made, whatever implements the loop.  Per channel-iteration the least
the card must move: the PSF's window read once, the residual's window
read and written once, float64; the window is the overlap of the image
with the PSF centred on the peak, least where the peak lies on the mask's
edge, (n - h_y) (n - h_x) pixels for a mask of half-sizes h.  Per channel:
the dirty image and the PSF read once, the model and the residual written
once.  Hogbom's arithmetic (a multiply-add a pixel) is far below the
bytes' time, so the bound is the bytes'."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

BYTES = 8                       # float64


def geometry(plan: Dict) -> Tuple[int, int, int]:
    """(n, h_y, h_x): the image's size and the CLEAN mask's half-sizes of
    a plan of ``benchmark/reference/observe.plan``."""
    mask = plan['mask'] != 0
    rows = int(torch.any(mask, 1).sum())
    cols = int(torch.any(mask, 0).sum())
    return int(plan['imsize']), rows // 2, cols // 2


def least_bytes(n: int, h_y: int, h_x: int, channels: int,
                channel_iterations: int) -> float:
    """Bytes the CLEAN of ``channels`` channels must move, over
    ``channel_iterations`` iterations summed over them."""
    window = (n - h_y) * (n - h_x)
    return float(3 * BYTES * window * channel_iterations +
                 4 * BYTES * n * n * channels)
