"""The plain reference of a jet configuration: the grid fill, the burst
factor at an epoch, the free-free and RRL opacities and the LOS sums into
EM, optical-depth and flux maps, written from the upstream RaJePy's
equations (classes.py and maths/ of https://github.com/SimonP2207/RaJePy)
as plain PyTorch over slabs of grid rows.

Every tensor is made in the ``dtype`` a call is given: float64 for the
reference, a lower precision for the control.  Python floats are constants;
each operation on a tensor rounds to its dtype.  Maps come back as float64
numpy arrays.  Supported: the q^d_v = 0 travel time (the bundled jet's), LTE
lines; anything else raises.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import constants as k
from .faddeeva import re_w
from .gaunt import gff

_DN = {'a': 1, 'b': 2, 'g': 3, 'd': 4}
_M_DN = {1: 0.190775, 2: 0.026332, 3: 0.0081056, 4: 0.0034918}
_KAPPA_P0 = 1.0991132675738456e-17          # G&S (2002) eq. 2.114
_BB_CBRT = (2.0 * k.H_CGS / k.C_CGS ** 2) ** (1.0 / 3.0)


def grid_dims(params: Dict):
    """(nx, ny, nz): from l_z [arcsec] when given (RaJePy classes.py:90-122:
    the jet length projected onto the grid, padded by the far end's jet
    width), else n_x/n_y/n_z; each made even."""
    g, geo = params['grid'], params['geometry']
    if g.get('l_z') is None:
        return tuple((g[n] + 1) // 2 * 2 for n in ('n_x', 'n_y', 'n_z'))
    cs, inc, pa = g['c_size'], geo['inc'], geo['pa']
    l_au = g['l_z'] * params['target']['dist']
    xmax = l_au * math.sin(math.radians(pa))
    ymax = l_au * math.tan(1.571 - math.radians(inc))
    zmax = l_au * math.cos(math.radians(pa))
    a, b = math.radians(inc - 90.0), math.radians(pa)
    rmax = math.sin(a) * ymax + math.cos(a) * (math.cos(b) * zmax -
                                               math.sin(b) * xmax)
    mr0 = mod_r_0(geo)
    wmax = geo['w_0'] * ((abs(rmax) + mr0 - geo['r_0']) / mr0) ** \
        geo['epsilon']
    pad = 2 * int(math.ceil(abs(wmax / cs)))
    dims = (int(math.ceil(abs(v / cs))) + pad for v in (xmax, ymax, zmax))
    return tuple(n + n % 2 for n in dims)


def mod_r_0(geo: Dict) -> float:
    return geo['epsilon'] * geo['w_0'] / math.tan(
        math.radians(geo['opang']) / 2.0)


def n_0_from_mlr(params: Dict) -> float:
    """Base density [cm^-3] of the blue jet from its mass-loss rate."""
    pr, pl, t = params['properties'], params['power_laws'], params['target']
    a = pl['q^d_n'] + pl['q^d_v']
    if a in (-1.0, -2.0):
        a *= 1.0 + 1e-12
    r1, r2 = t['R_1'] * k.AU, t['R_2'] * k.AU
    shape = ((r1 ** 2 + r2 * (r2 * (a + 1.0) - r1 * (a + 2.0)) *
              (r2 / r1) ** a) / ((r2 - r1) ** 2 * (a + 1.0) * (a + 2.0)))
    const = (2.0 * math.pi * pr['mu'] * k.atomic_mass('H') *
             pr['v_0'] * 1e3 * (params['geometry']['w_0'] * k.AU) ** 2)
    return pr['mlr_bj'] * k.MSOL / k.YEAR / const / shape / 1e6


class Line:
    """Constants of a recombination line such as 'H58a'."""

    def __init__(self, name: str):
        self.element = name.rstrip('abgd').rstrip('0123456789')
        self.n = int(name[len(self.element):-1])
        self.dn = _DN[name[-1]]
        self.z = k.z_number(self.element)
        m = k.atomic_mass(self.element)
        r = k.RYDBERG * m / (m + k.M_E)
        self.nu0 = r * k.C * self.z ** 2 * (1.0 / self.n ** 2 -
                                            1.0 / (self.n + self.dn) ** 2)
        self.mass = m
        self.fn1n2 = self.n * _M_DN[self.dn] * (1.0 + 1.5 * self.dn / self.n)
        self.energy = -2.17989724e-11 * self.z ** 2 / self.n ** 2
        mh, mhe = (k.MASS_MICRO_U[a] * 1e-6 for a in ('H', 'He'))
        mu = (0.710 / mh + 0.276 / mhe + 0.014 / 14.24) ** -1
        self.ni_per_ne = 0.710 * mu / (m / k.U_AMU)


class Jet:
    """One configuration's jet, its derived scalars and bursts."""

    def __init__(self, params: Dict):
        p = copy.deepcopy(params)
        if p['power_laws']['q^d_v'] != 0.0:
            raise NotImplementedError("the reference's travel time needs "
                                      "q^d_v = 0")
        self.p = p
        self.geo, self.pl = p['geometry'], p['power_laws']
        self.pr, self.tg = p['properties'], p['target']
        self.cs = p['grid']['c_size']
        self.nx, self.ny, self.nz = grid_dims(p)
        self.mr0 = mod_r_0(self.geo)
        self.q_n = -self.pl['q_v'] - 2.0 * self.geo['epsilon']
        self.n_0 = n_0_from_mlr(p)
        self.rb_frac = self.pr['mlr_rj'] / self.pr['mlr_bj']
        self.van_hoof = self.pl['q_T'] == 0.0
        ej = p['ejection']
        fwhm = 2.0 * math.sqrt(2.0 * math.log(2.0))
        # (t0 [s], sigma [s], chi - 1, red side)
        self.bursts = []
        for side in ('R', 'B'):
            for t0, hl, chi, which in zip(ej['t_0'], ej['hl'], ej['chi'],
                                          ej['which']):
                if side in str(which).upper():
                    self.bursts.append((t0 * k.YEAR, hl * 2.0 / fwhm * k.YEAR,
                                        chi - 1.0, side == 'R'))

    # ------------------------------------------------------------------ #
    # the fill
    # ------------------------------------------------------------------ #
    def rows(self) -> int:
        """Grid rows (x) per slab: about 2**23 cells."""
        return max(1, min(self.nx, 2 ** 23 // (self.ny * self.nz)))

    def _rwp(self, x, y, z):
        """Observer frame -> jet frame (r, w, phi): rotate about y by pa,
        then about x by inc - 90, then cylindrical about the new z."""
        a = math.radians(self.geo['inc'] - 90.0)
        b = math.radians(self.geo['pa'])
        xd = math.cos(b) * x + math.sin(b) * z
        zb = math.cos(b) * z - math.sin(b) * x
        yd = math.cos(a) * y - math.sin(a) * zb
        zd = math.sin(a) * y + math.cos(a) * zb
        w = torch.sqrt(xd * xd + yd * yd)
        phi = torch.asin(yd / w)
        phi = torch.where(xd < 0, math.pi - phi, phi)
        return zd, w, phi

    def _rho(self, r):
        return 1.0 + (r.abs() - self.geo['r_0']) / self.mr0

    def _w_r(self, r):
        return self.geo['w_0'] * self._rho(r) ** self.geo['epsilon']

    def slab(self, x0: int, x1: int, dtype, device) -> Dict[str, torch.Tensor]:
        """The fields of grid rows [x0, x1): ``inside``, ``ff``, ``nd``
        (without bursts), ``xi``, ``temp``, ``vy``, ``ts`` [s], ``red``."""
        cs, r_0 = self.cs, self.geo['r_0']

        def axis(i0, i1, n, shape):
            i = torch.arange(i0, i1, dtype=dtype, device=device)
            return (cs * (i - n // 2)).reshape(shape)

        x = axis(x0, x1, self.nx, (-1, 1, 1))
        y = axis(0, self.ny, self.ny, (1, -1, 1))
        z = axis(0, self.nz, self.nz, (1, 1, -1))
        n_in = None
        for dx in (0.0, cs):
            for dy in (0.0, cs):
                for dz in (0.0, cs):
                    r, w, _ = self._rwp(x + dx, y + dy, z + dz)
                    c = (self._w_r(r) >= w) & (r.abs() >= r_0)
                    n_in = c.to(torch.int8) if n_in is None else n_in + c
        inside = n_in > 0
        zero = torch.zeros((), dtype=dtype, device=device)
        ff = torch.where(n_in == 8, torch.ones_like(zero),
                         torch.where(inside, torch.full_like(zero, 0.5), zero))
        h = cs / 2.0
        rr, ww, pp = self._rwp(x + h, y + h, z + h)
        t = self.tg
        reff = t['R_1'] + (t['R_2'] - t['R_1']) * ww / self._w_r(rr)
        ra = rr.abs()
        ra = torch.where((ra < r_0) & (ra + h >= r_0), (r_0 + ra + h) / 2.0,
                         ra)
        rho_a = self._rho(ra)

        def power_law(v0, q, qd):
            v = v0 * rho_a ** q * (reff / t['R_1']) ** qd
            return torch.where(inside, v, zero)

        pl, pr = self.pl, self.pr
        nd = power_law(self.n_0, self.q_n, pl['q^d_n'])
        nd = torch.where(rr < 0, nd * self.rb_frac, nd)
        xi = power_law(pr['x_0'], pl['q_x'], pl['q^d_x'])
        temp = power_law(pr['T_0'], pl['q_T'], pl['q^d_T'])
        vz_j = power_law(pr['v_0'], pl['q_v'], pl['q^d_v']) * torch.sign(rr)
        v_rot = torch.sqrt(k.G * t['M_star'] * k.MSOL / (reff * k.AU)) * \
            self._rho(rr) ** -self.geo['epsilon'] / 1e3
        sense = 1.0 if self.geo['rotation'].lower() == 'ccw' else -1.0
        vx_j = torch.where(inside, -v_rot * torch.sin(pp) * sense, zero)
        vy_j = torch.where(inside, v_rot * torch.cos(pp) * sense, zero)
        # rotate the jet-frame velocity about x by 90 - inc, then about y
        # by -pa; only the LOS (y) component is kept
        a = math.radians(90.0 - self.geo['inc'])
        vy = math.cos(a) * vy_j - math.sin(a) * vz_j
        vy = torch.where(inside, vy + t['v_lsr'], zero)
        del vx_j
        # travel time from the launch surface (q^d_v = 0: the 2F1 factor
        # is 1), in seconds
        q_v = pl['q_v']
        const = (self.mr0 * k.AU) ** q_v / (pr['v_0'] * 1e3 * (1.0 - q_v))

        def rad(r):
            return (r + self.mr0 - r_0) * k.AU

        ts = const * (rad(ra) ** (1.0 - q_v) -
                      rad(torch.full_like(ra, r_0)) ** (1.0 - q_v))
        ts = ts / k.YEAR * 31536000.0
        shape = (x1 - x0, self.ny, self.nz)
        out = dict(inside=inside, ff=ff, nd=nd, xi=xi, temp=temp, vy=vy,
                   ts=ts, red=rr < 0)
        return {n: v.expand(shape).contiguous() for n, v in out.items()}

    def chi(self, red, launch_time):
        """Burst factor jml(t)/jml_ss of each cell's side."""
        chi = torch.ones_like(launch_time)
        for t0, sig, amp, is_red in self.bursts:
            g = amp * torch.exp(-(launch_time - t0) ** 2 / (2.0 * sig ** 2))
            chi = chi + torch.where(red == is_red, g, torch.zeros_like(g))
        return chi

    def ds_cm(self, s):
        return self.cs * k.AU2CM * s['ff']

    # ------------------------------------------------------------------ #
    # products
    # ------------------------------------------------------------------ #
    def _tau_base(self, temp, n_es, ds, inside):
        t = torch.where(inside, temp, torch.ones_like(temp))
        if self.van_hoof:
            base = 0.018 * t ** -1.5 * n_es ** 2 * ds
        else:
            base = 0.018 * 11.95 * t ** -1.35 * n_es ** 2 * ds
        return torch.where(inside, base, torch.zeros_like(base))

    def tau_scale(self, freqs, t_0):
        """tau_ff(nu) / sum_y base: nu^-2 g_ff(nu, T_0), or nu^-2.1."""
        if self.van_hoof:
            return freqs ** -2.0 * gff(freqs, t_0)
        return freqs ** -2.1

    def flux_scale(self) -> float:
        return math.atan(self.cs * k.AU /
                         (self.tg['dist'] * k.PARSEC)) ** 2 / 1e-26

    def _accumulate(self, times, dtype, device, per_slab=None):
        """One pass over the slabs: for each epoch the maps sum_y tau_base,
        sum_y EM; the LOS temperature sum and jet-cell count; and whatever
        ``per_slab(x0, slab, n_es_by_epoch)`` adds."""
        nx, nz = self.nx, self.nz
        zeros = [torch.zeros(nx, nz, dtype=dtype, device=device)
                 for _ in range(2 * len(times) + 1)]
        a_maps, em_maps, tsum = zeros[:len(times)], zeros[len(times):-1], \
            zeros[-1]
        count = torch.zeros(nx, nz, dtype=torch.int64, device=device)
        ds_pc_unit = self.cs * k.AU / k.PARSEC
        for x0 in range(0, nx, self.rows()):
            x1 = min(nx, x0 + self.rows())
            s = self.slab(x0, x1, dtype, device)
            ds = self.ds_cm(s)
            n_es = []
            for i, t in enumerate(times):
                chi = self.chi(s['red'], t - s['ts'])
                ne = s['nd'] * chi * s['xi']
                n_es.append(ne)
                a_maps[i][x0:x1] += self._tau_base(s['temp'], ne, ds,
                                                   s['inside']).sum(1)
                em_maps[i][x0:x1] += (ne ** 2 * ds_pc_unit * s['ff']).sum(1)
            tsum[x0:x1] += torch.where(s['inside'], s['temp'],
                                       torch.zeros_like(s['temp'])).sum(1)
            count[x0:x1] += s['inside'].sum(1)
            if per_slab is not None:
                per_slab(x0, s, ds, n_es)
        any_in = count > 0
        tbar = torch.where(any_in, tsum / count.clamp_min(1).to(dtype),
                           torch.zeros_like(tsum))
        return a_maps, em_maps, tbar, any_in

    def continuum(self, times: Sequence[float], freqs, dtype=torch.float64,
                  device='cpu') -> List[tuple]:
        """(em, tau, flux) maps per epoch [s] for the channels ``freqs``
        [Hz]: EM [pc cm^-6] (nx, nz), tau and flux [Jy/pixel] (n, nx, nz)."""
        f = torch.as_tensor(np.asarray(freqs, np.float64), device=device
                            ).to(dtype)
        a_maps, em_maps, tbar, any_in = self._accumulate(times, dtype,
                                                         device)
        scale = self.tau_scale(f, self.pr['T_0'])[:, None, None]
        out = []
        for a, em in zip(a_maps, em_maps):
            tau = scale * a[None]
            out.append(tuple(_np(v) for v in (
                em, tau, self.ff_flux(f, tau, tbar, any_in))))
        return out

    def ff_flux(self, f, tau, tbar, any_in):
        """Free-free flux maps [Jy/pixel]."""
        ints = 2.0 * f[:, None, None] ** 2 * k.K_B * tbar[None] * \
            (-torch.expm1(-tau)) / k.C ** 2
        return torch.where(any_in[None], ints, torch.zeros_like(ints)) * \
            self.flux_scale()

    def rrl(self, line: str, times: Sequence[float], freqs,
            contsub: bool = False, dtype=torch.float64, device='cpu',
            chan_block: int = 64) -> List[tuple]:
        """(em, tau_line, flux) maps per epoch [s] of an LTE line over the
        channels ``freqs`` [Hz]; flux with the continuum unless
        ``contsub``."""
        ln = Line(line)
        f = torch.as_tensor(np.asarray(freqs, np.float64), device=device
                            ).to(dtype)
        d_f = torch.as_tensor(np.asarray(freqs, np.float64) - ln.nu0,
                              device=device).to(dtype)
        nx, nz = self.nx, self.nz
        taus = [torch.zeros(len(freqs), nx * nz, dtype=dtype, device=device)
                for _ in times]

        def per_slab(x0, s, ds, n_es):
            ins = s['inside']
            pix = (torch.arange(s['inside'].shape[0], device=device)[:, None,
                                                                      None]
                   + x0) * nz + torch.arange(nz, device=device)[None, None]
            pix = pix.expand(ins.shape)[ins]
            temp, vy, dsj = s['temp'][ins], s['vy'][ins], ds[ins]
            for i, ne in enumerate(n_es):
                tau = self.line_tau(ln, d_f, f, temp, ne[ins], vy, dsj,
                                    chan_block)
                taus[i].index_add_(1, pix, tau)

        a_maps, em_maps, tbar, any_in = self._accumulate(
            times, dtype, device, per_slab)
        scale = self.tau_scale(f, self.pr['T_0'])[:, None, None]
        out = []
        for a, em, tau_l in zip(a_maps, em_maps, taus):
            tau_l = tau_l.reshape(-1, nx, nz)
            tau_c = scale * a[None]
            flux = self.line_intensity(f, tbar, any_in, tau_c, tau_l) * \
                self.flux_scale()
            if not contsub:
                flux = flux + self.ff_flux(f, tau_c, tbar, any_in)
            out.append(tuple(_np(v) for v in (em, tau_l, flux)))
        return out

    @staticmethod
    def line_tau(ln: Line, d_f, f, temp, n_e, vy, ds, chan_block=64):
        """Per-cell line opacity tau = kappa_L ds (n_chan, n_cells) of jet
        cells; channel offsets ``d_f`` = f - nu0 keep low precisions
        from quantising f."""
        d_rest = -ln.nu0 * vy * 1e3 / k.C           # rest - nu0
        rest = ln.nu0 + d_rest
        fwhm_g = torch.sqrt(8.0 * k.LN2 * k.K_B * temp /
                            (ln.mass * k.C ** 2)) * rest
        fwhm_l = 8.2 * n_e * (ln.n / 100.0) ** 4.5 * \
            (1.0 + 2.25 * ln.dn / ln.n)
        sigma = fwhm_g / (2.0 * math.sqrt(2.0 * k.LN2))
        s = 1.0 / (sigma * math.sqrt(2.0))
        y = 0.5 * fwhm_l * s
        amp = (_KAPPA_P0 * ln.n ** 2 * ln.fn1n2 * n_e *
               (n_e * ln.ni_per_ne) * temp ** -1.5 *
               torch.exp(ln.z ** 2 * ln.energy / (k.K_CGS * temp)) * ds /
               (sigma * math.sqrt(2.0 * math.pi)))
        hkt = k.H_CGS / (k.K_CGS * temp)
        out = []
        for c0 in range(0, d_f.shape[0], chan_block):
            x = (d_f[c0:c0 + chan_block, None] - d_rest[None]) * s[None]
            stim = -torch.expm1(-f[c0:c0 + chan_block, None] * hkt[None])
            out.append(re_w(x, y[None]) * amp[None] * stim)
        return torch.cat(out)

    @staticmethod
    def line_intensity(f, tbar, any_in, tau_c, tau_l):
        """LTE line intensity B_nu(Tbar) e^-tau_c (1 - e^-tau_l)
        [W m^-2 Hz^-1 sr^-1], zero off the jet."""
        t = torch.where(any_in, tbar, torch.ones_like(tbar))[None]
        f3 = (_BB_CBRT * f[:, None, None]) ** 3
        b_nu = f3 / torch.expm1(k.H_CGS * f[:, None, None] / (k.K_CGS * t))
        ints = b_nu * torch.exp(-tau_c) * (-torch.expm1(-tau_l)) * 1e-3
        return torch.where(any_in[None], ints, torch.zeros_like(ints))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float64).cpu().numpy()
