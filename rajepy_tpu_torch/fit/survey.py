"""Parameter surveys: the forward model over a grid of parameter sets
(the JAX package's ``fit/__init__.py:1619-1724``)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ._params import (SUPPORTED_FREE, _check_free, _check_mesh,
                      _mesh_devices)
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
    With ``mesh``, combo k runs on device k mod n of the mesh's first
    axis, with the forward built again (on ``jm._replica``) on a device
    other than the model's; the values equal those with ``mesh=None``.
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

    if kind not in ('sed', 'map', 'rrl_spectrum'):
        raise ValueError(f"unknown sweep kind {kind!r}")
    if kind == 'rrl_spectrum' and line is None:
        raise ValueError("kind='rrl_spectrum' needs line=")

    def build(model):
        if kind == 'sed':
            return build_sed_forward(model, freqs, paths, time, dtype)[0]
        if kind == 'map':
            return build_flux_forward(model, freqs, paths, time, dtype)[0]
        return build_rrl_spectrum_forward(model, line, freqs, paths, time,
                                          dtype)[0]

    n = thetas.shape[0]
    step = batch_size or n
    th = torch.as_tensor(thetas, device=jm.device)
    devs = _mesh_devices(mesh, th.device)
    forwards = {}
    for dev in devs:
        if dev not in forwards:
            forwards[dev] = build(jm if dev == th.device else
                                  jm._replica(dev))
    out = []
    with torch.no_grad():
        for lo in range(0, n, step):
            vals = [forwards[devs[k % len(devs)]](th[k].to(
                devs[k % len(devs)])) for k in range(lo, min(lo + step, n))]
            out.append(torch.stack([v.to(th.device) for v in vals])
                       .cpu().numpy())
    return SweepResult(paths=paths,
                       points={p: c for p, c in zip(paths, cols)},
                       values=np.concatenate(out), shape=shape)
