"""Physical field evaluation on the voxel grid — the grid fill (PyTorch port
of rajepy_tpu.models.fields).

Each function maps ``(static params, broadcastable coords) -> tensor``.
Masking convention: fields are finite everywhere (zero outside the jet)
with ``inside`` the boolean jet-membership mask; the reference's NaN view
is rebuilt only at the JetModel API boundary.

Reference formula sources (RaJePy classes.py):
* fill factors / projected areas: 8-vertex inside test, 639-769
* number density 872-899, ion fraction 910-936, temperature 942-996 (with
  the au/cm slip fixed, as the JAX package), velocity 1009-1099
* travel time ts: 838-855 (+ geometry.py:121-178)
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch

from ..ops import geometry as geom
from ..ops import physics as phys


Scalar = Union[float, torch.Tensor]


class Geometry(NamedTuple):
    """Geometric/physical scalars extracted from a params dict: Python
    floats, or 0-d tensors where a fit frees them (the fill is then
    differentiable in them)."""
    w_0: Scalar
    r_0: Scalar
    mod_r_0: Scalar
    epsilon: Scalar
    inc: Scalar
    pa: Scalar
    r_1: Scalar
    r_2: Scalar
    csize: float

    @classmethod
    def from_params(cls, params: Dict) -> "Geometry":
        g, t = params['geometry'], params['target']
        return cls(w_0=g['w_0'], r_0=g['r_0'], mod_r_0=g['mod_r_0'],
                   epsilon=g['epsilon'], inc=g['inc'], pa=g['pa'],
                   r_1=t['R_1'], r_2=t['R_2'],
                   csize=params['grid']['c_size'])


def _zeros_where_not(mask, vals):
    return torch.where(mask, vals, torch.zeros_like(vals))


# --------------------------------------------------------------------------- #
# Coordinates
# --------------------------------------------------------------------------- #
def centre_rwp(gm: Geometry, xc, yc, zc):
    """Cell-centre jet-frame coordinates (r, w, phi) (classes.py:515-526)."""
    return geom.xyz_to_rwp(xc, yc, zc, gm.inc, gm.pa)


def effective_radius(gm: Geometry, rr, ww):
    """Disc launch radius r_eff per cell (classes.py:544-557)."""
    return geom.r_eff(ww, gm.r_1, gm.r_2, gm.w_0, rr.abs(), gm.mod_r_0,
                      gm.r_0, gm.epsilon)


def adjusted_r(gm: Geometry, rr):
    """|r|, with cells straddling the launch surface nudged to the mean of
    (r_0, r + csize/2) (classes.py:884-886 et al.)."""
    r = rr.abs()
    straddles = (r < gm.r_0) & ((r + gm.csize / 2.0) >= gm.r_0)
    return torch.where(straddles, (gm.r_0 + r + gm.csize / 2.0) / 2.0, r)


# --------------------------------------------------------------------------- #
# Fill factors and projected areas
# --------------------------------------------------------------------------- #
def fill_factor_area(gm: Geometry, xx, yy, zz) -> Tuple[torch.Tensor,
                                                        torch.Tensor,
                                                        torch.Tensor]:
    """8-corner inside/outside test (classes.py:657-669).

    A voxel corner is inside the jet when its jet-frame width coordinate
    lies within the local jet boundary w(r) and |r| is beyond the launch
    radius.  ff = 1 for 8 corners inside, 0.5 for a partial cell, 0
    outside; the projected area is 1 whenever any corner is inside.

    Args are *corner* coordinates (broadcastable).  Each corner's full-cube
    temporaries are dropped before the next corner is evaluated, so the
    loop holds the int8 corner count plus one corner's working set.
    Returns ``(ff, area, inside)`` with zeros outside.
    """
    cs = gm.csize
    n_inside = None
    for dx in (0.0, cs):
        for dy in (0.0, cs):
            for dz in (0.0, cs):
                rv, wv, _ = geom.xyz_to_rwp(xx + dx, yy + dy, zz + dz,
                                            gm.inc, gm.pa)
                wrv = geom.w_r(rv, gm.w_0, gm.mod_r_0, gm.r_0, gm.epsilon)
                corner_in = (wrv >= wv) & (rv.abs() >= gm.r_0)
                del rv, wv, wrv
                if n_inside is None:
                    n_inside = corner_in.to(torch.int8)
                else:
                    n_inside += corner_in
                del corner_in
    dt = xx.dtype
    one = torch.ones((), dtype=dt, device=xx.device)
    half = torch.full((), 0.5, dtype=dt, device=xx.device)
    zero = torch.zeros((), dtype=dt, device=xx.device)
    inside = n_inside > 0
    ff = torch.where(n_inside == 8, one, torch.where(inside, half, zero))
    area = torch.where(inside, one, zero)
    return ff, area, inside


# --------------------------------------------------------------------------- #
# Scalar fields
# --------------------------------------------------------------------------- #
def _power_law_field(gm: Geometry, zero_val, q, qd, rr, reff, inside):
    """Shared cell-value power law with launch-surface nudge and masking
    (pattern of classes.py:884-899)."""
    r = adjusted_r(gm, rr)
    vals = geom.cell_value(zero_val, geom.rho(r, gm.r_0, gm.mod_r_0), reff,
                           gm.r_1, q, qd)
    return _zeros_where_not(inside, vals)


def number_density(gm: Geometry, params: Dict, rr, reff, inside,
                   rb_frac: float):
    """Static (chi-independent) number density [cm^-3]
    (classes.py:872-899).  Red jet (r < 0) scaled by the red/blue
    steady-state mass-loss ratio."""
    pl = params['power_laws']
    nd = _power_law_field(gm, params['properties']['n_0'], pl['q_n'],
                          pl['q^d_n'], rr, reff, inside)
    return torch.where(rr < 0, nd * rb_frac, nd)


def ion_fraction(gm: Geometry, params: Dict, rr, reff, inside):
    """Ionisation fraction (classes.py:910-936)."""
    pl = params['power_laws']
    return _power_law_field(gm, params['properties']['x_0'], pl['q_x'],
                            pl['q^d_x'], rr, reff, inside)


def temperature(gm: Geometry, params: Dict, rr, reff, inside):
    """Temperature [K] (classes.py:942-996, with the au/cm slip fixed)."""
    pl = params['power_laws']
    return _power_law_field(gm, params['properties']['T_0'], pl['q_T'],
                            pl['q^d_T'], rr, reff, inside)


def velocity(gm: Geometry, params: Dict, rr, pp, reff, inside):
    """Observer-frame velocity components (vx, vy, vz) [km/s]
    (classes.py:1009-1099): power-law outflow along the jet axis plus
    Keplerian rotation decomposed by azimuth, the whole field rotated by
    (90 - inc, -pa) and v_lsr added along the line of sight (y)."""
    pl = params['power_laws']
    p = params['properties']

    vz_jet = _power_law_field(gm, p['v_0'], pl['q_v'], pl['q^d_v'], rr, reff,
                              inside)
    vz_jet = vz_jet * torch.sign(rr)

    vr = phys.v_rot(rr, reff, geom.rho(rr, gm.r_0, gm.mod_r_0), gm.epsilon,
                    params['target']['M_star'])
    sense = 1.0 if params['geometry']['rotation'].lower() == 'ccw' else -1.0
    vx_jet = _zeros_where_not(inside, -vr * torch.sin(pp) * sense)
    vy_jet = _zeros_where_not(inside, vr * torch.cos(pp) * sense)

    vx, vy, vz = geom.xyz_rotate(vx_jet, vy_jet, vz_jet, 90.0 - gm.inc,
                                 -gm.pa, order='xy')
    vy = vy + params['target']['v_lsr']
    return (_zeros_where_not(inside, vx), _zeros_where_not(inside, vy),
            _zeros_where_not(inside, vz))


def travel_time_years(gm: Geometry, params: Dict, rr, ww):
    """Travel time from launch surface to each cell [years]
    (classes.py:838-855; closed-form integral of geometry.py:121-178)."""
    r = adjusted_r(gm, rr)
    pl = params['power_laws']
    return geom.t_rw(r, ww, w_0=gm.w_0, r_0=gm.r_0,
                     v_0=params['properties']['v_0'], mr0=gm.mod_r_0,
                     eps=gm.epsilon, r_1=gm.r_1, r_2=gm.r_2,
                     q_v=pl['q_v'], q_vd=pl['q^d_v'])


class StaticFields(NamedTuple):
    """Time-independent grids held on the model's device (the RT working
    set): the LOS velocity component only, and a red-jet boolean instead
    of the full jet-frame r cube."""
    ff: torch.Tensor        # fill factors (0 outside)
    area: torch.Tensor      # projected areas (0 outside)
    inside: torch.Tensor    # bool jet-membership mask
    nd: torch.Tensor        # number density without burst factor [cm^-3]
    xi: torch.Tensor        # ionisation fraction
    temp: torch.Tensor      # temperature [K]
    vy: torch.Tensor        # LOS velocity component [km/s]
    ts: torch.Tensor        # travel time since launch [s]
    red: torch.Tensor       # bool: red-jet side (r < 0)


def compute_static_fields(params: Dict, xx, yy, zz, rb_frac: float,
                          with_time: bool = True) -> StaticFields:
    """Evaluate every time-independent grid.

    ``xx, yy, zz`` are *corner* coordinate tensors (broadcastable); centre
    coordinates are corner + csize/2 (classes.py:521-523).  Every returned
    field is a contiguous (nx, ny, nz) tensor.  The scalar leaves of
    ``params`` (and ``rb_frac``) may be 0-d tensors: the float fields are
    then differentiable in them (the masks are not).
    """
    gm = Geometry.from_params(params)
    half = gm.csize / 2.0
    xc, yc, zc = xx + half, yy + half, zz + half

    ff, area, inside = fill_factor_area(gm, xx, yy, zz)
    rr, ww, pp = centre_rwp(gm, xc, yc, zc)
    reff = effective_radius(gm, rr, ww)

    nd = number_density(gm, params, rr, reff, inside, rb_frac)
    xi = ion_fraction(gm, params, rr, reff, inside)
    temp = temperature(gm, params, rr, reff, inside)
    _, vy, _ = velocity(gm, params, rr, pp, reff, inside)
    del pp, reff
    if with_time:
        # NB: unmasked — the reference evaluates travel time for every cell
        # (classes.py:838-855) and the burst factor samples it everywhere
        ts = travel_time_years(gm, params, rr, ww) * 31536000.0
    else:
        ts = torch.zeros_like(nd)

    shape = torch.broadcast_shapes(xx.shape, yy.shape, zz.shape)

    def full(t):
        return t.expand(shape).contiguous()

    return StaticFields(
        ff=full(ff), area=full(area), inside=full(inside), nd=full(nd),
        xi=full(xi), temp=full(temp), vy=full(vy), ts=full(ts),
        red=full(rr < 0))


def static_fields_from_numpy(d, device='cpu',
                             dtype: torch.dtype = torch.float64
                             ) -> StaticFields:
    """Carry fields across from the JAX package: ``d`` is a mapping (or a
    NamedTuple such as ``rajepy_tpu.models.fields.StaticFields``) of the
    nine field names to array-likes.  Float fields become ``dtype`` tensors
    on ``device``; ``inside`` and ``red`` become bool tensors."""
    if hasattr(d, '_asdict'):
        d = d._asdict()
    out = {}
    for name in StaticFields._fields:
        a = np.asarray(d[name])
        if name in ('inside', 'red'):
            out[name] = torch.as_tensor(a.astype(bool), device=device)
        else:
            out[name] = torch.as_tensor(a.astype(np.float64),
                                        device=device).to(dtype)
    return StaticFields(**out)
