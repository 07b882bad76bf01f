"""Free parameters of a fit: the supported paths, their encoding into the
optimisation vector ``theta``, and the JetModel derivation chain re-run on
0-d tensors (the JAX package's ``fit/__init__.py:66-204``)."""
from __future__ import annotations

import copy
from typing import Dict, Sequence

import numpy as np
import torch

from ..ops import geometry as geom
from ..ops import physics as phys

YEAR = 31536000.0

#: transform per fittable path: 'log' (positive-definite) or 'linear'
SUPPORTED_FREE = {
    'properties.mlr_bj': 'log',
    'properties.mlr_rj': 'log',
    'properties.T_0': 'log',
    'properties.x_0': 'log',
    'properties.v_0': 'log',
    'power_laws.q_T': 'linear',
    'power_laws.q_x': 'linear',
    'power_laws.q_v': 'linear',
    'geometry.inc': 'linear',
    'geometry.pa': 'linear',
    'geometry.opang': 'linear',
    'geometry.epsilon': 'linear',
    'target.dist': 'log',
    # systemic LSR velocity [km/s, receding positive]: shifts RRL profiles;
    # the continuum forwards are velocity-independent, so its gradient is
    # only nonzero through build_rrl_forward
    'target.v_lsr': 'linear',
    # non-LTE departure coefficients (pseudo-paths, not params-dict
    # entries; only the RRL forwards accept them, and param_dict skips
    # them).  A profile constrains roughly one combination of the two:
    # free one with the other pinned unless another observable breaks the
    # degeneracy.
    'nonlte.b_n1': 'log',
    'nonlte.b_n2': 'log',
}

#: the pseudo-paths only the RRL forwards implement
_NONLTE_FREE = ('nonlte.b_n1', 'nonlte.b_n2')

#: paths that move the travel times' 2F1 series (its argument or its c):
#: named in the error where ``ops.hyp2f1`` refuses a derivative through the
#: series (q^d_v != 0 on a model with bursts)
_SERIES_FREE = ('geometry.inc', 'geometry.pa', 'geometry.opang',
                'geometry.epsilon', 'power_laws.q_v')


def _split_nonlte(free):
    """(real_free, real_idx, nl_idx): the params-dict paths, their theta
    positions, and the {pseudo-path: theta position} map."""
    free = tuple(free)
    nl_idx = {p: i for i, p in enumerate(free) if p in _NONLTE_FREE}
    real_free = tuple(p for p in free if p not in _NONLTE_FREE)
    real_idx = [i for i, p in enumerate(free) if p not in _NONLTE_FREE]
    return real_free, real_idx, nl_idx


def _get(d: Dict, path: str):
    sec, key = path.split('.')
    return d[sec][key]


def _set(d: Dict, path: str, value):
    sec, key = path.split('.')
    d[sec] = dict(d[sec])
    d[sec][key] = value


def _check_free(free: Sequence[str], allow_nonlte: bool = False):
    for p in free:
        if p not in SUPPORTED_FREE:
            raise ValueError(
                f"unsupported free parameter {p!r}; supported: "
                f"{sorted(SUPPORTED_FREE)} (n_0/q_n are derived — free "
                f"'properties.mlr_bj' / 'geometry.epsilon' instead)")
        if p in _NONLTE_FREE and not allow_nonlte:
            raise ValueError(
                f"{p!r} is only meaningful in the RRL forwards "
                "(build_rrl_forward / fit_rrl_spectrum / fit_rrl_cube)")


def _check_mesh(mesh):
    """``mesh=`` is None or a mesh of ``parallel.sharding`` (a
    ``Mesh``: ``devices``, ``axis_names``)."""
    if mesh is not None and not (hasattr(mesh, 'devices') and
                                 hasattr(mesh, 'axis_names')):
        raise TypeError(f"mesh= takes a parallel.sharding.Mesh, got "
                        f"{type(mesh).__name__}")


def _mesh_devices(mesh, device) -> list:
    """The devices that ``mesh=`` spreads a fit's starts or a sweep's
    combos over, item k to device k mod n: the first device of each index
    along the mesh's first axis (the axis the JAX package shards them
    over); ``[device]`` without a mesh."""
    if mesh is None:
        return [torch.device(device)]
    from ..parallel.sharding import _axis_devices
    return _axis_devices(mesh, mesh.axis_names[0])


def _grad(value, theta):
    """d value / d theta, zeros where ``value`` does not depend on theta
    (e.g. ``target.v_lsr`` in a continuum forward), as ``jax.grad``
    gives."""
    if not value.requires_grad:
        return torch.zeros_like(theta)
    g, = torch.autograd.grad(value, theta, allow_unused=True,
                             materialize_grads=True)
    return g


def _encode(free, params, device):
    """params -> optimisation vector (log for positive params), float64 on
    ``device``."""
    out = []
    for p in free:
        v = float(_get(params, p))
        out.append(np.log(v) if SUPPORTED_FREE[p] == 'log' else v)
    return torch.as_tensor(np.asarray(out, np.float64), device=device)


def _as_theta(theta, dtype, device):
    """``theta`` (numpy, list or tensor) as a ``dtype`` tensor on
    ``device``, keeping its autograd graph."""
    if isinstance(theta, torch.Tensor):
        return theta.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(theta, np.float64),
                           device=device).to(dtype)


def _substitute(free, params, theta):
    """A params dict with 0-d tensors at the free paths and the JetModel
    derivation chain (mod_r_0, q_n, q_tau, n_0, the red/blue ratio) re-run
    on them."""
    q = copy.copy(params)
    for i, p in enumerate(free):
        v = theta[i]
        if SUPPORTED_FREE[p] == 'log':
            v = torch.exp(v)
        _set(q, p, v)
    g, pl, pr, t = (dict(q['geometry']), dict(q['power_laws']),
                    dict(q['properties']), q['target'])
    g['mod_r_0'] = geom.mod_r_0(g['opang'], g['epsilon'], g['w_0'])
    pl['q_n'] = phys.q_n(g['epsilon'], pl['q_v'])
    pl['q_tau'] = phys.q_tau(g['epsilon'], pl['q_x'], pl['q_n'], pl['q_T'])
    pr['n_0'] = phys.n_0_from_mlr(
        pr['mlr_bj'], pr['v_0'], g['w_0'], pr['mu'],
        pl['q^d_n'], pl['q^d_v'], t['R_1'], t['R_2'])
    q['geometry'], q['power_laws'], q['properties'] = g, pl, pr
    rb_frac = pr['mlr_rj'] / pr['mlr_bj']
    return q, rb_frac


def _gaunt_branch(params, free) -> bool:
    """Gaunt treatment of the fit forwards (van Hoof iff q_T == 0).  A
    freed q_T always takes the smooth Reynolds form: the exact-zero switch
    has no derivative, and a fit started at q_T = 0 would otherwise keep
    the van Hoof form while q_T moves."""
    return (params['power_laws']['q_T'] != 0.0 or
            'power_laws.q_T' in list(free))


def _values(free, theta_np) -> Dict[str, float]:
    """theta (numpy) -> {path: value} in value space."""
    out = {}
    for i, p in enumerate(free):
        v = float(theta_np[i])
        out[p] = float(np.exp(v)) if SUPPORTED_FREE[p] == 'log' else v
    return out


def _jet_cells(inside):
    """Flat indices of the jet cells of an (nx, ny, nz) mask."""
    return torch.nonzero(inside.reshape(-1)).squeeze(1)


def _los_maps(vals, cells, shape):
    """Per-cell values ``vals`` (n_cells,) at the flat ``cells`` of an
    ``shape`` = (nx, ny, nz) grid, summed along the line of sight (y) into
    an (nx, nz) map: zeros elsewhere, summed in the full grid's order, so
    the map is what the full-grid sum of the masked cube gives and does not
    depend on the device's scheduling (no atomics)."""
    full = vals.new_zeros(int(np.prod(shape))).index_put((cells,), vals)
    return full.reshape(shape).sum(dim=1)
