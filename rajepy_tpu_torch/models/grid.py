"""Static grid construction (PyTorch port of rajepy_tpu.models.grid).

* ``lz_to_grid_dims``  — classes.py:90-122, on the host in numpy
* corner/centred coordinates — classes.py:465-523 (bottom-left-front cell
  corners in au, 'ij'-indexed, centred on the grid midpoint)

Coordinates are *broadcastable* rank-3 tensors of shapes (nx, 1, 1),
(1, ny, 1), (1, 1, nz): field code broadcasts them instead of
materialising three full (nx, ny, nz) meshgrids up front.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# Line-of-sight axis: y is axis 1 for 'ij' indexing (classes.py:363-372),
# as ops.radtrans.LOS_AXIS
LOS_AXIS = 1


def _xyz_to_r(x: float, y: float, z: float, inc: float, pa: float) -> float:
    """Jet-frame r of one observer-frame point (ops.geometry.xyz_to_rwp in
    float64 numpy)."""
    a = np.radians(inc - 90.0)
    b = np.radians(pa)
    # 'yx' order: rotate about y by pa, then about x by inc - 90
    zd = np.cos(b) * z - np.sin(b) * x
    yd = y
    return float(np.sin(a) * yd + np.cos(a) * zd)


def lz_to_grid_dims(params: Dict) -> Tuple[int, int, int]:
    """Derive (nx, ny, nz) from the plane-of-sky jet length ``l_z`` [arcsec]
    (classes.py:90-122): project l_z into model x/y/z, pad by the jet width
    at the far end, enforce even dims."""
    cs_au = params["grid"]["c_size"]
    inc = params["geometry"]["inc"]
    pa = params["geometry"]["pa"]
    i_rads = np.radians(inc)
    pa_rads = np.radians(pa)
    l_xz_au = params['grid']['l_z'] * params['target']['dist']

    xmax_au = l_xz_au * np.sin(pa_rads)
    ymax_au = l_xz_au * np.tan(1.571 - i_rads)
    zmax_au = l_xz_au * np.cos(pa_rads)

    g = params["geometry"]
    rmax_au = _xyz_to_r(xmax_au, ymax_au, zmax_au, inc, pa)
    rho = (abs(rmax_au) + g["mod_r_0"] - g["r_0"]) / g["mod_r_0"]
    wmax_au = g["w_0"] * rho ** g["epsilon"]
    wmax_cells = int(np.ceil(np.abs(wmax_au / cs_au)))

    nx = int(np.ceil(np.abs(xmax_au / cs_au)))
    ny = int(np.ceil(np.abs(ymax_au / cs_au)))
    nz = int(np.ceil(np.abs(zmax_au / cs_au)))

    # Pad by jet width so the jet fits even at inc/pa of 0/90/180/270 deg
    nx, ny, nz = (n + 2 * wmax_cells for n in (nx, ny, nz))

    # Enforce even dims
    return tuple(n if n % 2 == 0 else n + 1 for n in (nx, ny, nz))


def grid_corner_coords(nx: int, ny: int, nz: int, csize: float,
                       dtype: torch.dtype = torch.float64,
                       device='cpu'):
    """Bottom-left-front corner coordinates in au as broadcastable tensors
    ((nx,1,1), (1,ny,1), (1,1,nz)); classes.py:489-501."""
    ix = torch.arange(nx, dtype=dtype, device=device).reshape(nx, 1, 1)
    iy = torch.arange(ny, dtype=dtype, device=device).reshape(1, ny, 1)
    iz = torch.arange(nz, dtype=dtype, device=device).reshape(1, 1, nz)
    return (csize * (ix - nx // 2),
            csize * (iy - ny // 2),
            csize * (iz - nz // 2))


def grid_centre_coords(nx: int, ny: int, nz: int, csize: float,
                       dtype: torch.dtype = torch.float64, device='cpu'):
    """Cell-centre coordinates (corner + csize/2; classes.py:521-523)."""
    xx, yy, zz = grid_corner_coords(nx, ny, nz, csize, dtype, device)
    half = csize / 2.0
    return xx + half, yy + half, zz + half
