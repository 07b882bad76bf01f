"""Run descriptors: per-observation value objects (a copy of
rajepy_tpu.models.runs, which holds no JAX).

API-compatible rebuild of the reference's ``ContinuumRun``
(classes.py:1716-1901) and ``RRLRun`` (classes.py:1903-1967): year/
frequency/bandwidth/telescope metadata, derived directory and FITS paths
(``<dcy>/Day<day>/<freq|line>/...``), channel grids, and the mutable
``completed``/``products``/``results`` state the pipeline checkpoints.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np

from ..ops import rrls as mrrl
from ..utils import misc as miscf


def _tabulate(rows, headers, units):
    """Minimal grid table (stands in for the tabulate dependency used at
    classes.py:1781-1782)."""
    heads = [h + (f"\n[{u}]" if u else "") for h, u in zip(headers, units)]
    head_lines = max(h.count('\n') + 1 for h in heads)
    head_cells = [(h.split('\n') + [''] * head_lines)[:head_lines]
                  for h in heads]
    widths = [max(len(line) for line in cell + [max(
        (str(r[i]) for r in rows), key=len, default='')])
        for i, cell in enumerate(head_cells)]
    sep = '+' + '+'.join('-' * (w + 2) for w in widths) + '+'
    out = [sep]
    for li in range(head_lines):
        out.append('|' + '|'.join(
            f" {head_cells[i][li]:<{widths[i]}} "
            for i in range(len(widths))) + '|')
    out.append(sep.replace('-', '='))
    for r in rows:
        out.append('|' + '|'.join(
            f" {str(v):<{widths[i]}} " for i, v in enumerate(r)) + '|')
        out.append(sep)
    return '\n'.join(out)


_HDR = ['Year', 'Type', 'Telescope', 't_obs', 't_int', 'Line', 'Frequency',
        'Bandwidth', 'Channel width', 'Radiative Transfer?',
        'Synthetic Obs.?', 'Completed?']
_UNITS = ['yr', '', '', 's', 's', '', 'Hz', 'Hz', 'Hz', '', '', '']
_FMT = ['.2f', '', '', '.0f', '.0f', '', '.3e', '.3e', '.3e', '', '', '']


def _fmt_row(vals):
    out = []
    for v, f in zip(vals, _FMT):
        if v is None:
            out.append('-')
        elif f and isinstance(v, (int, float, np.floating, np.integer)):
            out.append(format(v, f))
        else:
            out.append(v)
    return out


class ContinuumRun:
    """One continuum observation of the model at one epoch
    (classes.py:1716-1901)."""

    def __init__(self, dcy: str, year: float,
                 freq: Optional[float] = None,
                 bandwidth: Optional[float] = None,
                 chanwidth: Optional[float] = None,
                 t_obs: Optional[float] = None,
                 t_int: Optional[float] = None,
                 tscop: Optional[Tuple[str, str]] = None):
        self._year = year
        self._dcy = dcy
        self._obs_type = 'continuum'
        self._freq = freq
        self._t_obs = t_obs
        self._t_int = t_int
        # coerce to builtin str: params arrive as numpy-array elements and
        # np.str_ reprs (`np.str_('VLA')`) would otherwise deface every
        # rendered run table / pipeline log under numpy 2
        self._tscop = (tuple(str(t) for t in tscop)
                       if tscop is not None else None)
        self._products = {}
        self._results = {}

        # Default bandwidth/channel width to 1 Hz (classes.py:1737-1745)
        self._bandwidth = bandwidth if bandwidth is not None else 1.0
        self._chanwidth = chanwidth if chanwidth is not None else 1.0

        self.completed = False
        self.radiative_transfer = freq is not None
        self.simobserve = not any(
            v is None for v in (tscop, bandwidth, chanwidth, t_obs, t_int))

    def __str__(self):
        vals = _fmt_row([self._year, self._obs_type.capitalize(),
                         self._tscop, self._t_obs, self._t_int, None,
                         self._freq, self._bandwidth, self._chanwidth,
                         self.radiative_transfer, self.simobserve,
                         self.completed])
        return _tabulate([vals], _HDR, _UNITS)

    # -- mutable state (classes.py:1786-1815) --------------------------- #
    @property
    def results(self) -> dict:
        return self._results

    @results.setter
    def results(self, new_results: dict):
        if not isinstance(new_results, dict):
            raise TypeError("setter method for results attribute requires "
                            "dict")
        self._results = new_results

    @property
    def products(self) -> dict:
        return self._products

    @products.setter
    def products(self, new_products: dict):
        if not isinstance(new_products, dict):
            raise TypeError("setter method for products attribute requires "
                            "dict")
        self._products = new_products

    # -- identity / paths (classes.py:1817-1900) ------------------------ #
    @property
    def obs_type(self) -> str:
        return self._obs_type

    @property
    def dcy(self) -> str:
        return self._dcy

    @dcy.setter
    def dcy(self, path: str):
        self._dcy = path

    @property
    def model_dcy(self) -> str:
        return os.sep.join([self.dcy, f'Day{self.day}'])

    @property
    def rt_dcy(self) -> Union[str, None]:
        if not self.radiative_transfer:
            return None
        return os.sep.join([self.model_dcy, miscf.freq_str(self.freq)])

    @property
    def year(self) -> float:
        return self._year

    @property
    def day(self) -> int:
        return int(self.year * 365.0)

    @property
    def freq(self):
        return self._freq

    @property
    def bandwidth(self):
        return self._bandwidth

    @property
    def chanwidth(self):
        return self._chanwidth

    @property
    def t_obs(self):
        return self._t_obs

    @property
    def t_int(self):
        return self._t_int

    @property
    def tscop(self):
        return self._tscop

    def _fits_path(self, prefix: str) -> str:
        return self.rt_dcy + os.sep + '_'.join(
            [prefix, 'Day' + str(self.day),
             miscf.freq_str(self.freq)]) + '.fits'

    @property
    def fits_flux(self) -> str:
        return self._fits_path('Flux')

    @property
    def fits_tau(self) -> str:
        return self._fits_path('Tau')

    @property
    def fits_em(self) -> str:
        return self._fits_path('EM')

    @property
    def nchan(self) -> int:
        return int(self.bandwidth / self.chanwidth)

    @property
    def chan_freqs(self) -> np.ndarray:
        """Channel centre frequencies (classes.py:1897-1900)."""
        chan1 = self.freq - self.bandwidth / 2.0 + self.chanwidth / 2.0
        return chan1 + np.arange(self.nchan) * self.chanwidth


class RRLRun(ContinuumRun):
    """One radio-recombination-line observation (classes.py:1903-1967)."""

    def __init__(self, dcy: str, year: float,
                 line: Optional[str] = None,
                 bandwidth: Optional[float] = None,
                 chanwidth: Optional[float] = None,
                 t_obs: Optional[float] = None,
                 t_int: Optional[float] = None,
                 tscp: Optional[Tuple[str, str]] = None,
                 lte: bool = True):
        self.line = str(line) if line is not None else None
        # beyond-reference: an optional 'lte' array in the rrls params
        # section runs this line's RT non-LTE (departure coefficients
        # auto-derived from the bundled case-B table; the reference has
        # no non-LTE mode at all).  Consumers use getattr(..., 'lte',
        # True) so pre-r4 pickled pipelines resume unchanged.
        self.lte = bool(lte)
        freq = mrrl.rrl_nu_0(*mrrl.rrl_parser(line))
        super().__init__(dcy, year, freq, bandwidth, chanwidth, t_obs, t_int,
                         tscp)
        self._obs_type = 'rrl'

    def __str__(self):
        vals = _fmt_row([self._year, self._obs_type.capitalize(),
                         self._tscop, self._t_obs, self._t_int, self.line,
                         self._freq, self._bandwidth, self._chanwidth,
                         self.radiative_transfer, self.simobserve,
                         self.completed])
        return _tabulate([vals], _HDR, _UNITS)

    @property
    def rt_dcy(self) -> Union[str, None]:
        if not self.radiative_transfer:
            return None
        return os.sep.join([self.model_dcy, self.line])

    def _fits_path(self, prefix: str) -> str:
        return self.rt_dcy + os.sep + '_'.join(
            [prefix, 'Day' + str(self.day), self.line]) + '.fits'


class Pointing:
    """A single telescope pointing: time, coordinates, duration
    (classes.py:3185-3233).  Vestigial in the reference's own pipeline but
    part of its public API; rebuilt astropy-free on ops.astronomy's
    sexagesimal parsers.
    """

    def __init__(self, time_, ra, dec, duration, epoch: str = 'J2000'):
        from ..ops import astronomy as astro
        self._time = time_
        self._duration = duration
        if epoch not in ('J2000', 'B1950'):
            raise ValueError("epoch, {}, is unsupported. Must be J2000 or "
                             "B1950".format(epoch))
        self._epoch = epoch
        self._ra_deg = astro.parse_ra(ra)
        self._dec_deg = astro.parse_dec(dec)
        # frame-correct J2000 coordinates: the reference's FK4-frame
        # SkyCoord (classes.py:3195-3200) lets consumers transform B1950
        # input; our tuple stand-in converts eagerly (zero-proper-motion
        # FK4->FK5, ops.astronomy.fk4_to_fk5, ~0.01" accuracy) instead of
        # silently treating B1950 degrees as J2000 (~0.7 deg error).
        if epoch == 'B1950':
            self._ra_j2000, self._dec_j2000 = astro.fk4_to_fk5(
                self._ra_deg, self._dec_deg)
        else:
            self._ra_j2000, self._dec_j2000 = self._ra_deg, self._dec_deg

    @property
    def time(self):
        return self._time

    @property
    def ra(self) -> str:
        """'hhhmmss.ssss'-style right ascension (classes.py:3209-3214)."""
        hours = self._ra_deg / 15.0
        h = int(hours)
        m = int((hours - h) * 60.0)
        s = (hours - h - m / 60.0) * 3600.0
        if s >= 59.99995:  # carry rounding like the reference's hms floats
            s = 0.0
            m += 1
        if m == 60:
            m = 0
            h += 1
        return '{:02.0f}h{:02.0f}m{:07.4f}'.format(h, m, s)

    @property
    def dec(self) -> str:
        """'+ddmmss.sss'-style declination (classes.py:3216-3221)."""
        sign = '-' if self._dec_deg < 0 else '+'
        adeg = abs(self._dec_deg)
        d = int(adeg)
        m = int((adeg - d) * 60.0)
        s = (adeg - d - m / 60.0) * 3600.0
        if s >= 59.9995:
            s = 0.0
            m += 1
        if m == 60:
            m = 0
            d += 1
        return '{}{:02.0f}d{:02.0f}m{:06.3f}'.format(sign, d, m, s)

    @property
    def duration(self):
        return self._duration

    @property
    def epoch(self) -> str:
        return self._epoch

    @property
    def coord(self):
        """(ra_deg, dec_deg) in the J2000/FK5 frame — in place of the
        reference's SkyCoord.  B1950 input is FK4->FK5 converted; use
        :attr:`coord_native` for the raw parsed values in the pointing's
        own epoch."""
        return (self._ra_j2000, self._dec_j2000)

    @property
    def coord_native(self):
        """(ra_deg, dec_deg) exactly as parsed, in ``epoch``'s frame."""
        return (self._ra_deg, self._dec_deg)
