"""Parameter surveys: the forward model over a grid of parameter sets
(the JAX package's ``fit/__init__.py:1619-1724``)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ._params import SUPPORTED_FREE, _check_free, _check_mesh
from .forwards import build_flux_forward, build_sed_forward
from .rrl import build_rrl_spectrum_forward


class SweepResult(NamedTuple):
    """Outcome of :func:`sweep`."""
    paths: Tuple[str, ...]       # swept parameter paths, in grid order
    points: Dict[str, np.ndarray]  # value of each path per combo (n,)
    values: np.ndarray           # (n, ...) forward outputs per combo
    shape: Tuple[int, ...]       # Cartesian grid shape (product mode)

    def reshaped(self):
        """``values`` with the combo axis unflattened to ``shape``
        (product mode only)."""
        return self.values.reshape(self.shape + self.values.shape[1:])


def sweep(jm, freqs, grid: Dict[str, Sequence], *, kind: str = 'sed',
          line: str = None, time=None, dtype=None,
          batch_size: int = None, mesh=None, product: bool = True
          ) -> SweepResult:
    """Evaluate the forward model over a grid of parameter sets on the
    model's device.

    ``grid`` maps parameter paths (any of :data:`SUPPORTED_FREE`; the
    ``nonlte.b_n*`` pseudo-paths need ``kind='rrl_spectrum'``) to 1-D
    value arrays, swept over their Cartesian product (``product=True``,
    default) or zipped elementwise (equal lengths required).

    ``kind``: ``'sed'`` — integrated fluxes, values ``(n, n_chan)``;
    ``'map'`` — flux maps ``(n, n_chan, nx, nz)``; ``'rrl_spectrum'`` —
    spatially-integrated line spectrum (needs ``line=``).

    Each combo is one evaluation of the forward, without gradients, so
    every combo's numbers are those of the single evaluation at its
    parameters.  ``batch_size`` is the number of combos whose outputs are
    gathered on the device before one copy to the host (default: all).
    """
    _check_mesh(mesh)
    paths = tuple(grid)
    # the nonlte.b_n* pseudo-paths exist only in the RRL forwards
    _check_free(paths, allow_nonlte=(kind == 'rrl_spectrum'))
    vals = [np.atleast_1d(np.asarray(grid[p], float)) for p in paths]
    if product:
        meshed = np.meshgrid(*vals, indexing='ij')
        shape = meshed[0].shape
        cols = [m.reshape(-1) for m in meshed]
    else:
        n = {v.size for v in vals}
        if len(n) != 1:
            raise ValueError("product=False needs equal-length value "
                             f"arrays, got sizes {sorted(n)}")
        shape = (vals[0].size,)
        cols = vals
    thetas = np.stack([np.log(c) if SUPPORTED_FREE[p] == 'log' else c
                       for p, c in zip(paths, cols)], axis=1)

    if kind == 'sed':
        forward, _ = build_sed_forward(jm, freqs, paths, time, dtype)
    elif kind == 'map':
        forward, _ = build_flux_forward(jm, freqs, paths, time, dtype)
    elif kind == 'rrl_spectrum':
        if line is None:
            raise ValueError("kind='rrl_spectrum' needs line=")
        forward, _ = build_rrl_spectrum_forward(jm, line, freqs, paths,
                                                time, dtype)
    else:
        raise ValueError(f"unknown sweep kind {kind!r}")

    n = thetas.shape[0]
    step = batch_size or n
    th = torch.as_tensor(thetas, device=jm.device)
    out = []
    with torch.no_grad():
        for lo in range(0, n, step):
            out.append(torch.stack([forward(t) for t in th[lo:lo + step]])
                       .cpu().numpy())
    return SweepResult(paths=paths,
                       points={p: c for p, c in zip(paths, cols)},
                       values=np.concatenate(out), shape=shape)
