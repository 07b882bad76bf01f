"""Observatory registry and antenna-configuration assets.

Replaces the reference's pandas-based casa/_observatories.py: parses the
bundled CASA Observatories table (quoted-string-aware, the parser contract
of _observatories.py:23-44) into plain dicts and maps (telescope,
configuration) -> antenna .cfg file.

Deliberate fix over the reference: VLA configurations 'B', 'C' and 'D' map
to vla.b.cfg / vla.c.cfg / vla.d.cfg — the reference points all three at
vla.a.cfg (_observatories.py:111-115, flagged in SURVEY §2.8) although the
correct files ship in its tree.

A copy of rajepy_tpu.synthobs.observatories, which holds no JAX.
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from .. import _config as cfg

EW_TELESCOPES = ('ATCA', 'WSRT')   # _observatories.py:18

_CFG_DIR = os.path.join(cfg.dcys['files'], 'antenna_configs')

# (telescope, configuration) -> cfg filename (_observatories.py:57-121,
# with the VLA B/C/D fix)
CFG_FILES: Dict[str, Dict[str, str]] = {
    'ACA': {'0': 'aca.cfg'},
    'ALMA': {f'C-{i}': f'alma.C-{i}.cfg' for i in range(1, 11)},
    'ATCA': {'6A': 'atca_6a.cfg', '6B': 'atca_6b.cfg',
             '6C': 'atca_6c.cfg', '6D': 'atca_6d.cfg'},
    'EMERLIN': {'0': 'emerlin.cfg'},
    'GMRT': {'0': 'gmrt.cfg'},
    'LOFAR': {'0': 'LOFAR.cfg'},
    'MeerKAT': {'0': 'meerkat.cfg'},
    'NGVLA': {'SBA': 'ngvla-sba-revC.cfg',
              'MIDSUBARRAY': 'ngvla-mid-subarray-revC.cfg',
              'CORE': 'ngvla-core-revC.cfg',
              'PLAINS': 'ngvla-plains-revC.cfg',
              'MAIN': 'ngvla-main-revC.cfg',
              'FULL': 'ngvla-revC.cfg',
              'LBA': 'ngvla-lba-revC.cfg'},
    'IRAM_PDB': {'A': 'pdbi-a.cfg', 'B': 'pdbi-b.cfg', 'C': 'pdbi-c.cfg',
                 'D': 'pdbi-d.cfg'},
    'SMA': {'SUBCOMPACT': 'sma.subcompact.cfg',
            'COMPACT': 'sma.compact.cfg',
            'EXTENDED': 'sma.extended.cfg',
            'VEXTENDED': 'sma.vextended.cfg'},
    'VLA': {'A': 'vla.a.cfg', 'BnA': 'vla.bna.cfg', 'B': 'vla.b.cfg',
            'CnB': 'vla.cnb.cfg', 'C': 'vla.c.cfg', 'DnC': 'vla.dnc.cfg',
            'D': 'vla.d.cfg'},
    'VLBA': {'0': 'vlba.cfg'},
    'WSRT': {'0': 'WSRT.cfg'},
}

# Representative SEFDs [Jy] per telescope for the thermal-noise model
# (radiometer equation), standing in for CASA's tsys-atm machinery
# (tasks.py:205 'tsys-atm').  Values are typical cm/mm-band figures from the
# public observatory documentation; override per-run via the noise kwarg.
DEFAULT_SEFD = {
    'VLA': 350.0, 'EMERLIN': 350.0, 'ALMA': 50.0, 'ACA': 120.0,
    'ATCA': 450.0, 'GMRT': 350.0, 'LOFAR': 1000.0, 'MeerKAT': 420.0,
    'NGVLA': 200.0, 'IRAM_PDB': 200.0, 'SMA': 5000.0, 'VLBA': 900.0,
    'WSRT': 400.0,
}


def cfg_file(tscop: str, configuration: str) -> str:
    """Full path to the antenna configuration file for (telescope, config)."""
    try:
        fname = CFG_FILES[tscop][str(configuration)]
    except KeyError:
        raise KeyError(f"No antenna configuration {configuration!r} for "
                       f"telescope {tscop!r}") from None
    return os.path.join(_CFG_DIR, fname)


def _split_quoted(line: str) -> List[str]:
    """Split on spaces outside double quotes (the reference's hand-rolled
    parser, _observatories.py:26-38)."""
    out, cur, in_q, quoted = [], [], False, False
    for ch in line.rstrip('\n'):
        if ch == '"':
            in_q = not in_q
            quoted = True   # an empty "" is still a field
        elif ch == ' ' and not in_q:
            if cur or quoted:
                out.append(''.join(cur))
                cur, quoted = [], False
        else:
            cur.append(ch)
    if cur or quoted:
        out.append(''.join(cur))
    return out


@lru_cache(maxsize=1)
def observatory_table() -> Dict[str, Dict[str, object]]:
    """Parse Observatories_table.txt -> {telescope: row dict}.  Numeric
    columns ('D' dtype row) become floats."""
    fname = os.path.join(_CFG_DIR, 'Observatories_table.txt')
    with open(fname, 'rt') as f:
        lines = f.readlines()
    header = _split_quoted(lines[0])
    dtypes = _split_quoted(lines[1])
    table = {}
    for line in lines[2:]:
        vals = _split_quoted(line)
        if len(vals) < len(header):
            vals += [''] * (len(header) - len(vals))
        row = {}
        for col, dt, val in zip(header, dtypes, vals):
            row[col] = float(val) if dt == 'D' and val != '' else val
        table[row['Name']] = row
    return table


def observatory_location(tscop: str) -> Tuple[float, float, float]:
    """(longitude_deg_east, latitude_deg, height_m) of the observatory
    reference position."""
    row = observatory_table()[tscop]
    return float(row['Long']), float(row['Lat']), float(row['Height'])


def _enu_to_ecef_offsets(enu: np.ndarray, lon_deg: float,
                         lat_deg: float) -> np.ndarray:
    """Local East-North-Up offsets -> ECEF offsets at (lon, lat)."""
    lam = np.radians(lon_deg)
    phi = np.radians(lat_deg)
    e, n, u = enu[:, 0], enu[:, 1], enu[:, 2]
    x = -np.sin(lam) * e - np.sin(phi) * np.cos(lam) * n + \
        np.cos(phi) * np.cos(lam) * u
    y = np.cos(lam) * e - np.sin(phi) * np.sin(lam) * n + \
        np.cos(phi) * np.sin(lam) * u
    z = np.cos(phi) * n + np.sin(phi) * u
    return np.stack([x, y, z], axis=1)


def read_antenna_config(path: str):
    """Parse a CASA antenna .cfg file.

    Returns dict with 'xyz' ((n_ant, 3) ECEF positions in metres), 'diam'
    (n_ant dishes in metres), 'names', 'observatory'.  Handles both
    'coordsys=XYZ' (absolute ECEF, e.g. vla.a.cfg) and 'coordsys=LOC'
    (local tangent-plane offsets, e.g. the ALMA configs) headers.
    """
    coordsys = 'XYZ'
    observatory = None
    rows = []
    names = []
    diams = []
    with open(path, 'rt') as f:
        for i, line in enumerate(f.readlines()):
            s = line.strip()
            if not s:
                continue
            if s.startswith('#'):
                body = s.lstrip('#').strip()
                if body.lower().startswith('coordsys='):
                    coordsys = body.split('=', 1)[1].strip()
                elif body.lower().startswith('observatory='):
                    observatory = body.split('=', 1)[1].strip()
                continue
            parts = s.split()
            rows.append([float(v) for v in parts[:3]])
            diams.append(float(parts[3]) if len(parts) > 3 else 25.0)
            names.append(parts[4] if len(parts) > 4 else f'A{i}')
    xyz = np.asarray(rows, dtype=float)
    if coordsys.upper().startswith('LOC'):
        # offsets relative to the observatory reference position.
        # CASA 'X Y Z' columns in the Observatories table are geocentric
        # km for some entries and metres-scale for others; rebuild the
        # ECEF centre from (lon, lat, height) on the WGS84 ellipsoid.
        obs = observatory or 'ALMA'
        lon, lat, _ = observatory_location(obs)
        row = observatory_table()[obs]
        centre = _geodetic_to_ecef(lon, lat, float(row['Height']))
        xyz = centre[None, :] + _enu_to_ecef_offsets(xyz, lon, lat)
    elif not coordsys.upper().startswith('XYZ'):
        # e.g. the bundled carma.*.cfg files declare coordsys=UTM;
        # treating easting/northing as ECEF silently yields garbage
        # baselines — refuse loudly instead
        raise ValueError(
            f"{os.path.basename(path)}: unsupported coordsys="
            f"{coordsys!r} (only XYZ and LOC are handled)")
    return {'xyz': xyz, 'diam': np.asarray(diams), 'names': names,
            'observatory': observatory}


def _geodetic_to_ecef(lon_deg: float, lat_deg: float,
                      height_m: float) -> np.ndarray:
    """WGS84 geodetic -> ECEF [m]."""
    a = 6378137.0
    f = 1.0 / 298.257223563
    e2 = f * (2 - f)
    lam = np.radians(lon_deg)
    phi = np.radians(lat_deg)
    n = a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
    x = (n + height_m) * np.cos(phi) * np.cos(lam)
    y = (n + height_m) * np.cos(phi) * np.sin(lam)
    z = (n * (1 - e2) + height_m) * np.sin(phi)
    return np.array([x, y, z])


def max_baseline(path: str) -> float:
    """Longest baseline length [m] over all antenna pairs — the beam
    estimate input (classes.py:2656-2675)."""
    xyz = read_antenna_config(path)['xyz']
    d = np.linalg.norm(xyz[None, :, :] - xyz[:, None, :], axis=-1)
    return float(d.max())
