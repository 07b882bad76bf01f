"""Random-groups UVFITS export/import for the native visibility sets (a
copy of rajepy_tpu.synthobs.uvfits: host numpy, byte for byte the same
files).

The reference's synthetic observations live inside CASA measurement sets
that any radio-interferometry package can open; this framework's native
path keeps visibilities in ``.vis.npz`` files that only it reads.  This
module closes that interoperability gap: :func:`write_uvfits` renders a
sampled visibility set as a standard random-groups UVFITS file — the
interchange format CASA (``importuvfits``), AIPS and difmap all ingest —
with the AIPS AN antenna table real imaging software requires, and
:func:`read_uvfits` parses it back (the round-trip oracle, and an import
path for visibilities produced elsewhere).

Dependency-free, like :mod:`rajepy_tpu_torch.io.fits` (astropy is not
part of the runtime footprint): the writer emits the header cards, group
parameters and binary-table bytes directly.

Conventions (AIPS memo 117 / the original UVFITS definition):

- group parameters ``UU---SIN``/``VV---SIN``/``WW---SIN`` are baseline
  coordinates in SECONDS (metres / c), for the same (u, v, w) the
  sampler's forward model used with its e^{-2 pi i (u l + v m + w (n-1))}
  measurement kernel (sampler.py:sample_vis_dft_w) — the AIPS sign
  convention;
- ``BASELINE`` = 256 * ant1 + ant2 with 1-based antenna numbers,
  ant1 < ant2;
- the date is split over two ``DATE`` parameters (integer-ish day +
  day fraction) so float32 group parameters keep millisecond precision;
  ``PZERO5`` carries the Julian-date origin;
- regular axes are (COMPLEX=3 [re, im, weight], STOKES=1 [I], FREQ,
  RA=1, DEC=1), float32 (``BITPIX=-32``), weights = 1/sigma^2 of the
  per-channel thermal noise (or 1 for noiseless sets);
- groups are time-sorted (time-major, baseline-minor — the 'TB' order
  AIPS tasks expect), which is the sampler's native flattening.

The reference has no counterpart (its measurement sets are CASA's own
product, classes.py:2510-2788); this is a beyond-reference addition so
native-path users can reprocess simulated data in real packages.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.misc import atomic_write
from ..io.fits import _card, BLOCK

C_MPS = 299792458.0
#: J2000.0 epoch's civil date, JD 2451544.5 = 2000-01-01T00:00:00 UTC —
#: the default observation date for simulated tracks (model time is the
#: jet's age, not a calendar date)
JD_2000_01_01 = 2451544.5


def _pad_block(b: bytes, fill: bytes = b'\x00') -> bytes:
    return b + fill * (-len(b) % BLOCK)


def _header_bytes(cards) -> bytes:
    text = ''.join(cards).encode('ascii')
    return _pad_block(text, b' ')


def write_uvfits(filename: str,
                 uvw_m: np.ndarray,
                 vis_re: np.ndarray,
                 vis_im: np.ndarray,
                 freqs_hz: np.ndarray,
                 ant_xyz: np.ndarray,
                 ant1: np.ndarray,
                 ant2: np.ndarray,
                 time_s: np.ndarray,
                 ra_deg: float,
                 dec_deg: float,
                 *,
                 sigma=0.0,
                 flags: Optional[np.ndarray] = None,
                 ant_names: Optional[Sequence[str]] = None,
                 source: str = 'TARGET',
                 telescope: str = 'ARRAY',
                 jd0: float = JD_2000_01_01,
                 overwrite: bool = True) -> str:
    """Write visibilities as a random-groups UVFITS file + AIPS AN table.

    Parameters
    ----------
    uvw_m : (n_vis, 3) baseline coordinates in metres.
    vis_re, vis_im : (n_chan, n_vis) visibility parts (the framework's
        device-boundary (re, im) float-pair convention).
    freqs_hz : (n_chan,) channel centre frequencies (uniform spacing).
    ant_xyz : (n_ant, 3) station positions in metres (ECEF/ITRF).
    ant1, ant2 : (n_vis,) 0-based antenna indices, ant1 < ant2.
    time_s : (n_vis,) visibility timestamps in seconds from the start of
        the (simulated) observation.
    sigma : per-channel thermal-noise rms (scalar or (n_chan,)); group
        weights are 1/sigma^2, or 1.0 where sigma == 0 (noiseless).
    flags : optional bool array broadcastable to (n_chan, n_vis);
        flagged visibilities get NEGATED weights (the UVFITS flagging
        convention — readers treat weight <= 0 as flagged).
    jd0 : Julian date of ``time_s == 0``.

    Returns the filename.
    """
    if os.path.exists(filename) and not overwrite:
        raise FileExistsError(filename)
    uvw_m = np.asarray(uvw_m, np.float64)
    vis_re = np.atleast_2d(np.asarray(vis_re, np.float64))
    vis_im = np.atleast_2d(np.asarray(vis_im, np.float64))
    freqs = np.atleast_1d(np.asarray(freqs_hz, np.float64))
    ant_xyz = np.asarray(ant_xyz, np.float64)
    n_chan, n_vis = vis_re.shape
    if vis_im.shape != (n_chan, n_vis):
        raise ValueError(f"vis_im shape {vis_im.shape} != vis_re "
                         f"{(n_chan, n_vis)}")
    if uvw_m.shape != (n_vis, 3):
        raise ValueError(f"uvw_m shape {uvw_m.shape} != {(n_vis, 3)}")
    if freqs.size != n_chan:
        raise ValueError(f"{freqs.size} frequencies for {n_chan} channels")
    ant1 = np.asarray(ant1, np.int64)
    ant2 = np.asarray(ant2, np.int64)
    if np.any(ant1 >= ant2):
        raise ValueError("UVFITS requires ant1 < ant2 per baseline")
    n_ant = ant_xyz.shape[0]
    if np.any(ant2 >= n_ant) or np.any(ant1 < 0):
        raise ValueError("antenna index out of range of ant_xyz")
    if n_ant > 255:
        # the classic BASELINE encoding holds 1..255 per antenna slot
        raise ValueError("the BASELINE convention supports <= 255 "
                         f"antennas (got {n_ant})")
    time_s = np.asarray(time_s, np.float64)
    if time_s.shape != (n_vis,):
        raise ValueError(f"time_s shape {time_s.shape} != {(n_vis,)}")

    chan_w = float(freqs[1] - freqs[0]) if n_chan > 1 else 1.0
    sig = np.broadcast_to(np.asarray(sigma, np.float64), (n_chan,))
    wgt = np.where(sig > 0.0, 1.0 / np.where(sig > 0.0, sig, 1.0) ** 2,
                   1.0)

    cards = [
        _card('SIMPLE', True, 'conforms to FITS standard'),
        _card('BITPIX', -32, 'array data type'),
        _card('NAXIS', 6, 'number of regular axes'),
        _card('NAXIS1', 0, 'random groups'),
        _card('NAXIS2', 3, 'complex: real, imag, weight'),
        _card('NAXIS3', 1, 'stokes'),
        _card('NAXIS4', int(n_chan), 'frequency channels'),
        _card('NAXIS5', 1, 'RA'),
        _card('NAXIS6', 1, 'DEC'),
        # FITS 4.0 3.3.2: GROUPS/PCOUNT/GCOUNT immediately follow the
        # last NAXISn card (EXTEND only after them)
        _card('GROUPS', True, 'random-groups UVFITS'),
        _card('PCOUNT', 6, 'group parameters'),
        _card('GCOUNT', int(n_vis), 'visibilities'),
        _card('EXTEND', True, 'antenna table follows'),
        _card('OBJECT', source),
        _card('TELESCOP', telescope),
        _card('INSTRUME', telescope),
        _card('EPOCH', 2000.0, 'equinox of RA/DEC'),
        _card('BSCALE', 1.0),
        _card('BZERO', 0.0),
        _card('BUNIT', 'JY'),
        _card('OBSRA', float(ra_deg), 'phase centre RA (deg)'),
        _card('OBSDEC', float(dec_deg), 'phase centre DEC (deg)'),
        _card('CTYPE2', 'COMPLEX'),
        _card('CRVAL2', 1.0), _card('CRPIX2', 1.0), _card('CDELT2', 1.0),
        _card('CTYPE3', 'STOKES'),
        _card('CRVAL3', 1.0, 'Stokes I'),
        _card('CRPIX3', 1.0), _card('CDELT3', 1.0),
        _card('CTYPE4', 'FREQ'),
        _card('CRVAL4', float(freqs[0]), 'first channel frequency (Hz)'),
        _card('CRPIX4', 1.0),
        _card('CDELT4', chan_w, 'channel width (Hz)'),
        _card('CTYPE5', 'RA'),
        _card('CRVAL5', float(ra_deg)),
        _card('CRPIX5', 1.0), _card('CDELT5', 1.0),
        _card('CTYPE6', 'DEC'),
        _card('CRVAL6', float(dec_deg)),
        _card('CRPIX6', 1.0), _card('CDELT6', 1.0),
        _card('PTYPE1', 'UU---SIN', 'baseline u (seconds)'),
        _card('PSCAL1', 1.0), _card('PZERO1', 0.0),
        _card('PTYPE2', 'VV---SIN', 'baseline v (seconds)'),
        _card('PSCAL2', 1.0), _card('PZERO2', 0.0),
        _card('PTYPE3', 'WW---SIN', 'baseline w (seconds)'),
        _card('PSCAL3', 1.0), _card('PZERO3', 0.0),
        _card('PTYPE4', 'BASELINE', '256*ant1 + ant2 (1-based)'),
        _card('PSCAL4', 1.0), _card('PZERO4', 0.0),
        _card('PTYPE5', 'DATE', 'Julian date part 1'),
        _card('PSCAL5', 1.0), _card('PZERO5', float(jd0)),
        _card('PTYPE6', 'DATE', 'Julian date part 2'),
        _card('PSCAL6', 1.0), _card('PZERO6', 0.0),
        # the JAX package's card: both packages write the same bytes
        _card('HISTORY', 'written by rajepy_tpu.synthobs.uvfits'),
        _card('END'),
    ]

    # group payload: (n_vis, 6 params + 3*n_chan data), float32 big-endian
    day = time_s / 86400.0
    day_int = np.floor(day)
    pars = np.empty((n_vis, 6), np.float32)
    pars[:, 0] = (uvw_m[:, 0] / C_MPS).astype(np.float32)
    pars[:, 1] = (uvw_m[:, 1] / C_MPS).astype(np.float32)
    pars[:, 2] = (uvw_m[:, 2] / C_MPS).astype(np.float32)
    pars[:, 3] = (256 * (ant1 + 1) + (ant2 + 1)).astype(np.float32)
    pars[:, 4] = day_int.astype(np.float32)
    pars[:, 5] = (day - day_int).astype(np.float32)

    data = np.empty((n_vis, n_chan, 3), np.float32)
    data[:, :, 0] = vis_re.T
    data[:, :, 1] = vis_im.T
    data[:, :, 2] = wgt[None, :]
    if flags is not None:
        fl = np.broadcast_to(np.asarray(flags, bool), (n_chan, n_vis))
        data[:, :, 2] = np.where(fl.T, -np.abs(data[:, :, 2]),
                                 data[:, :, 2])
    groups = np.concatenate(
        [pars, data.reshape(n_vis, 3 * n_chan)], axis=1).astype('>f4')

    an_bytes = _an_table_bytes(ant_xyz, ant_names, telescope,
                               float(freqs[0]), jd0)

    with atomic_write(filename) as f:
        f.write(_header_bytes(cards))
        f.write(memoryview(np.ascontiguousarray(groups)).cast('B'))
        f.write(b'\x00' * (-groups.nbytes % BLOCK))
        f.write(an_bytes)
    return filename


def _an_table_bytes(ant_xyz: np.ndarray,
                    ant_names: Optional[Sequence[str]],
                    array_name: str, ref_freq_hz: float,
                    jd0: float) -> bytes:
    """AIPS AN binary-table extension (header + rows), the antenna
    catalogue CASA's importuvfits and AIPS require to map BASELINE codes
    to stations."""
    n_ant = ant_xyz.shape[0]
    if ant_names is None:
        ant_names = [f'ANT{i + 1:03d}' for i in range(n_ant)]

    cols = [            # (TTYPE, TFORM, TUNIT, bytes)
        ('ANNAME', '8A', '', 8),
        ('STABXYZ', '3D', 'METERS', 24),
        ('ORBPARM', '0D', '', 0),
        ('NOSTA', '1J', '', 4),
        ('MNTSTA', '1J', '', 4),
        ('STAXOF', '1E', 'METERS', 4),
        ('POLTYA', '1A', '', 1),
        ('POLAA', '1E', 'DEGREES', 4),
        ('POLCALA', '1E', '', 4),
        ('POLTYB', '1A', '', 1),
        ('POLAB', '1E', 'DEGREES', 4),
        ('POLCALB', '1E', '', 4),
    ]
    row_bytes = sum(c[3] for c in cols)

    cards = [
        _card('XTENSION', 'BINTABLE', 'binary table'),
        _card('BITPIX', 8),
        _card('NAXIS', 2),
        _card('NAXIS1', row_bytes, 'bytes per row'),
        _card('NAXIS2', n_ant, 'antennas'),
        _card('PCOUNT', 0), _card('GCOUNT', 1),
        _card('TFIELDS', len(cols)),
        _card('EXTNAME', 'AIPS AN'),
        _card('EXTVER', 1),
    ]
    for i, (name, form, unit, _) in enumerate(cols, start=1):
        cards.append(_card(f'TTYPE{i}', name))
        cards.append(_card(f'TFORM{i}', form))
        if unit:
            cards.append(_card(f'TUNIT{i}', unit))
    cards += [
        # per-station absolute ECEF coordinates -> zero array centre
        _card('ARRAYX', 0.0), _card('ARRAYY', 0.0), _card('ARRAYZ', 0.0),
        _card('GSTIA0', 0.0, 'GST at IAT=0 (deg; simulated track)'),
        _card('DEGPDY', 360.98564497330, 'earth rotation rate (deg/day)'),
        _card('FREQ', float(ref_freq_hz), 'reference frequency (Hz)'),
        _card('RDATE', _jd_to_date(jd0), 'reference date'),
        _card('POLARX', 0.0), _card('POLARY', 0.0),
        _card('UT1UTC', 0.0), _card('DATUTC', 0.0),
        _card('TIMSYS', 'UTC'),
        _card('ARRNAM', array_name[:8]),
        _card('XYZHAND', 'RIGHT'),
        _card('FRAME', 'ITRF'),
        _card('NUMORB', 0), _card('NOPCAL', 0), _card('NO_IF', 1),
        _card('FREQID', -1), _card('IATUTC', 0.0),
        _card('END'),
    ]

    rows = bytearray()
    for i in range(n_ant):
        rows += f'{ant_names[i]:<8.8}'.encode('ascii')
        rows += np.asarray(ant_xyz[i], '>f8').tobytes()
        rows += np.asarray([i + 1], '>i4').tobytes()        # NOSTA
        rows += np.asarray([0], '>i4').tobytes()            # MNTSTA alt-az
        rows += np.asarray([0.0], '>f4').tobytes()          # STAXOF
        rows += b'R'
        rows += np.asarray([0.0, 0.0], '>f4').tobytes()     # POLAA, POLCALA
        rows += b'L'
        rows += np.asarray([0.0, 0.0], '>f4').tobytes()     # POLAB, POLCALB
    assert len(rows) == row_bytes * n_ant
    return _header_bytes(cards) + _pad_block(bytes(rows))


def _jd_to_date(jd: float) -> str:
    """Julian date -> 'YYYY-MM-DD' (Fliegel & Van Flandern 1968)."""
    j = int(jd + 0.5)
    f = j + 1401 + (((4 * j + 274277) // 146097) * 3) // 4 - 38
    e = 4 * f + 3
    g = (e % 1461) // 4
    h = 5 * g + 2
    day = (h % 153) // 5 + 1
    month = (h // 153 + 2) % 12 + 1
    year = e // 1461 - 4716 + (12 + 2 - month) // 12
    return f'{year:04d}-{month:02d}-{day:02d}'


# ---------------------------------------------------------------------- #
# reader                                                                  #
#                                                                          #
# Supported-format matrix (see also tests/test_synthobs.py::TestUVFITS*): #
#                                                                          #
#   layout variant                      | behaviour                        #
#   ------------------------------------+--------------------------------- #
#   GROUPS random-groups, BITPIX=-32    | supported (anything else is a    #
#                                       | clear ValueError)                #
#   COMPLEX axis length 3 (re,im,wt)    | supported                        #
#   COMPLEX axis length 2 (re,im)       | supported, weights = 1           #
#   regular-axis order                  | any (axes located by CTYPE)      #
#   STOKES: single I plane              | supported                        #
#   STOKES: RR,LL / XX,YY (+ cross     | supported - parallel hands are   #
#   hands)                              | weight-averaged to I; flagged    #
#                                       | hands drop out; cross ignored    #
#   STOKES: single RR/LL/XX/YY          | supported (treated as an I       #
#                                       | estimate; assumes unpolarised)   #
#   STOKES: cross-hand only (RL/XY...)  | ValueError naming the codes      #
#   single IF axis (or none)            | supported; an FQ table, when     #
#                                       | present, governs single-IF       #
#                                       | frequencies too (IF FREQ offset  #
#                                       | + sideband-signed CH WIDTH)      #
#   multi-IF + AIPS FQ table            | supported - IFs stack IF-major   #
#                                       | onto the channel axis with the   #
#                                       | FQ frequency offsets/sidebands   #
#   multi-IF without an FQ table        | ValueError                       #
#   multi-setup (multi-row) FQ table    | supported when FREQSEL is        #
#                                       | constant: the FRQSEL-matched     #
#                                       | row is used (missing/unmatched   #
#                                       | FRQSEL is a ValueError, even     #
#                                       | for one-row tables)              #
#   FREQSEL / SOURCE group params       | supported when constant;         #
#                                       | multi-setup/multi-source files   #
#                                       | are a ValueError                 #
#   other extensions between tables     | skipped by the full FITS         #
#   (heap bintables, IMAGE HDUs)        | data-unit size (BITPIX, GCOUNT,  #
#                                       | PCOUNT, all NAXISn)              #
#   nX bit columns in AN/FQ tables      | occupy ceil(n/8) bytes (values   #
#                                       | skipped, offsets correct)        #
#   DATE as two parameters              | supported (summed)               #
#   DATE as one parameter               | supported                        #
#   PZERO/PSCAL on any parameter        | applied (incl. UU/VV/WW)         #
#   BASELINE = 256 a1 + a2              | supported                        #
#   BASELINE >= 65536 (2048 a1 + a2     | supported (the AIPS >255-antenna #
#   + 65536 extension)                  | extension)                       #
#   ANTENNA1/ANTENNA2 params instead    | supported                        #
#   neither BASELINE nor ANTENNA1/2     | ValueError                       #
#   weights <= 0                        | returned as-is; consumers        #
#                                       | (fit_uvfits) treat them as       #
#                                       | flagged                          #
# ---------------------------------------------------------------------- #

def _read_header(raw: bytes, pos: int):
    """Parse one FITS header starting at ``pos``: returns (dict of the
    LAST value per key, ordered (key, value) list, next position)."""
    from ..io.fits import _parse_value
    hdr: Dict[str, object] = {}
    ordered = []
    while True:
        block = raw[pos:pos + BLOCK].decode('ascii', errors='replace')
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        pos += BLOCK
        done = False
        for i in range(0, BLOCK, 80):
            card = block[i:i + 80]
            key = card[:8].strip()
            if key == 'END':
                done = True
                break
            if not key or card[8:10] != '= ':
                continue
            rest = card[10:]
            if rest.lstrip().startswith("'"):
                q = rest.index("'")
                q2 = rest.index("'", q + 1)
                while q2 + 1 < len(rest) and rest[q2 + 1] == "'":
                    q2 = rest.index("'", q2 + 2)
                value = _parse_value(rest[:q2 + 1])
            else:
                value = _parse_value(rest.split('/', 1)[0])
            hdr[key] = value
            ordered.append((key, value))
        if done:
            return hdr, ordered, pos


#: Stokes/correlation codes of the FITS convention (positive: true
#: Stokes; negative: correlations)
_STOKES_NAMES = {1: 'I', 2: 'Q', 3: 'U', 4: 'V', -1: 'RR', -2: 'LL',
                 -3: 'RL', -4: 'LR', -5: 'XX', -6: 'YY', -7: 'XY',
                 -8: 'YX'}
_PARALLEL_HANDS = ((-1, -2), (-5, -6))   # (RR, LL), (XX, YY)

#: bytes per repeat element ('X' bit columns are special-cased: an nX
#: column occupies ceil(n/8) bytes TOTAL, not n bytes; 'P'/'Q' are the
#: 8/16-byte variable-length-array descriptors — the heap data itself
#: lives past NAXIS1*NAXIS2 and is never needed by AN/FQ columns)
_TFORM_SIZES = {'A': 1, 'E': 4, 'J': 4, 'D': 8, 'I': 2, 'L': 1, 'B': 1,
                'K': 8, 'C': 8, 'M': 16, 'P': 8, 'Q': 16}
_TFORM_DTYPES = {'E': '>f4', 'J': '>i4', 'D': '>f8', 'I': '>i2'}


def _read_bintable(raw: bytes, ehdr: Dict[str, object],
                   dpos: int) -> Dict[str, object]:
    """Parse a BINTABLE extension's columns into {TTYPE: list | (n_rows,
    rep) array} (character columns decode to stripped strings)."""
    n_rows = int(ehdr['NAXIS2'])
    row = int(ehdr['NAXIS1'])
    cols = {}
    off = 0
    for i in range(1, int(ehdr['TFIELDS']) + 1):
        form = str(ehdr[f'TFORM{i}']).strip()
        if '(' in form:                 # rPt(emax) / rQt(emax) variants
            form = form[:form.index('(')]
        # the FIRST letter is the column code: for variable-length
        # descriptors ('1PB') that is P/Q, not the element type after it
        alpha = next(k for k, ch in enumerate(form) if ch.isalpha())
        code = form[alpha]
        rep = int(form[:alpha]) if form[:alpha] else 1
        name = str(ehdr.get(f'TTYPE{i}', f'COL{i}')).strip()
        cols[name] = (off, code, rep)
        off += (rep + 7) // 8 if code == 'X' else rep * _TFORM_SIZES[code]
    if off > row:
        raise ValueError(f"BINTABLE row length {row} < summed column "
                         f"widths {off}")
    out: Dict[str, object] = {}
    for name, (o, code, rep) in cols.items():
        if code == 'A':
            out[name] = [raw[dpos + k * row + o:dpos + k * row + o + rep]
                         .decode('ascii', errors='replace').strip()
                         for k in range(n_rows)]
        elif code in _TFORM_DTYPES:
            out[name] = np.stack([
                np.frombuffer(raw, _TFORM_DTYPES[code], count=rep,
                              offset=dpos + k * row + o)
                for k in range(n_rows)]) if n_rows else \
                np.zeros((0, rep))
        # L/X columns are not needed by AN/FQ tables; skipped
    return out


def _read_extensions(raw: bytes, pos: int) -> Dict[str, tuple]:
    """Scan FITS extensions after ``pos``: {EXTNAME: (header, columns)}."""
    exts = {}
    while pos < len(raw):
        try:
            ehdr, _, dpos = _read_header(raw, pos)
        except (ValueError, KeyError):
            break
        # general FITS data-unit size: |BITPIX|/8 * GCOUNT * (PCOUNT +
        # prod NAXISn) — covers bintable heaps (PCOUNT>0) and image
        # extensions (BITPIX != 8) that a bare NAXIS1*NAXIS2 would
        # under-skip, landing the scan mid-data
        n_ax = int(ehdr.get('NAXIS', 0))
        dims = 0
        if n_ax:
            dims = 1
            for k in range(1, n_ax + 1):
                dims *= int(ehdr.get(f'NAXIS{k}', 1))
        nbytes = (abs(int(ehdr.get('BITPIX', 8))) // 8) * \
            int(ehdr.get('GCOUNT', 1)) * (int(ehdr.get('PCOUNT', 0)) + dims)
        pos = dpos + ((nbytes + BLOCK - 1) // BLOCK) * BLOCK
        name = str(ehdr.get('EXTNAME', '')).strip()
        if str(ehdr.get('XTENSION', '')).strip() == 'BINTABLE' and name:
            try:
                exts[name] = (ehdr, _read_bintable(raw, ehdr, dpos))
            except (ValueError, KeyError):    # unparseable column set:
                exts[name] = (ehdr, {})       # keep the header only
    return exts


def _combine_stokes(dat: np.ndarray, codes: np.ndarray):
    """(g, n_st, n_chan, [re, im, wt]) -> Stokes-I (g, n_chan, 3).

    A single I/parallel-hand plane passes through; RR+LL (or XX+YY) are
    weight-averaged with flagged (weight <= 0) hands dropping out of the
    average; anything else is a clear error.
    """
    codes = [int(c) for c in codes]
    names = [_STOKES_NAMES.get(c, str(c)) for c in codes]
    if 1 in codes:
        return dat[:, codes.index(1)]
    for pair in _PARALLEL_HANDS:
        if pair[0] in codes and pair[1] in codes:
            a = dat[:, codes.index(pair[0])]
            b = dat[:, codes.index(pair[1])]
            wa = np.maximum(a[..., 2], 0.0)
            wb = np.maximum(b[..., 2], 0.0)
            wsum = wa + wb
            div = np.where(wsum > 0.0, wsum, 1.0)
            out = np.empty_like(a)
            out[..., 0] = (wa * a[..., 0] + wb * b[..., 0]) / div
            out[..., 1] = (wa * a[..., 1] + wb * b[..., 1]) / div
            out[..., 2] = wsum    # flagged where both hands flagged
            return out
    if len(codes) == 1 and codes[0] in (-1, -2, -5, -6):
        # a lone parallel hand is an I estimate for unpolarised sources
        return dat[:, 0]
    raise ValueError(
        "cannot form Stokes I from correlations "
        f"{names}: need an I plane, an RR/LL or XX/YY pair, or a single "
        "parallel hand")


def read_uvfits(filename: str) -> Dict[str, np.ndarray]:
    """Read a random-groups UVFITS file written by :func:`write_uvfits`
    or by real packages (CASA ``exportuvfits``, AIPS FITTP).  The
    supported-format matrix is documented at the top of this section;
    unsupported layouts raise ``ValueError`` naming the offending
    construct rather than mis-reading.

    Returns a dict: ``uvw`` (n_vis, 3) in METRES, ``ant1``/``ant2``
    (0-based), ``jd`` (n_vis) full Julian dates, ``vis_re``/``vis_im``
    (n_chan, n_vis) Stokes-I parts, ``weights`` (n_chan, n_vis; <= 0
    means flagged), ``freqs`` (n_chan,; IF-major when IFs were stacked),
    ``n_if``/``stokes`` layout info, ``ra_deg``/``dec_deg``/``source``,
    ``ant_xyz``/``ant_names`` from the AN table (empty if absent).
    """
    with open(filename, 'rb') as f:
        raw = f.read()
    hdr, ordered, pos = _read_header(raw, 0)
    if not hdr.get('GROUPS') or int(hdr.get('NAXIS1', -1)) != 0:
        raise ValueError(f"{filename}: not a random-groups UVFITS file")
    if int(hdr['BITPIX']) != -32:
        raise ValueError(
            f"only BITPIX=-32 UVFITS is supported (got {hdr['BITPIX']})")
    naxes = [int(hdr[f'NAXIS{i}']) for i in
             range(1, int(hdr['NAXIS']) + 1)]
    pcount = int(hdr['PCOUNT'])
    gcount = int(hdr['GCOUNT'])
    per_group = pcount + int(np.prod(naxes[1:]))
    if pos + gcount * per_group * 4 > len(raw):
        raise ValueError(f"{filename}: truncated group data "
                         f"(GCOUNT={gcount}, PCOUNT={pcount})")
    flat = np.frombuffer(raw, '>f4', count=gcount * per_group,
                         offset=pos).reshape(gcount, per_group)
    pos += ((gcount * per_group * 4 + BLOCK - 1) // BLOCK) * BLOCK
    exts = _read_extensions(raw, pos)

    # group-parameter columns by PTYPE (DATE may appear once or twice)
    pscal = [float(hdr.get(f'PSCAL{i}', 1.0)) for i in range(1, pcount + 1)]
    pzero = [float(hdr.get(f'PZERO{i}', 0.0)) for i in range(1, pcount + 1)]
    ptypes = [str(hdr.get(f'PTYPE{i}', '')).strip()
              for i in range(1, pcount + 1)]

    def par_idx(prefix):
        return [i for i, t in enumerate(ptypes) if t.startswith(prefix)]

    def par(prefix, required=True):
        idx = par_idx(prefix)
        if not idx:
            if required:
                raise ValueError(f"no {prefix} group parameter "
                                 f"(PTYPEs: {ptypes})")
            return None
        # multi-part parameters (DATE) sum: value = sum(p_i*scal + zero)
        return sum(flat[:, i].astype(np.float64) * pscal[i] + pzero[i]
                   for i in idx)

    uvw = np.stack([par('UU'), par('VV'), par('WW')], axis=1) * C_MPS
    bl = par('BASELINE', required=False)
    if bl is not None:
        bl_code = np.round(bl).astype(np.int64)
        ext = bl_code >= 65536          # AIPS >255-antenna extension:
        a1 = np.where(ext, (bl_code - 65536) // 2048, bl_code // 256)
        a2 = np.where(ext, (bl_code - 65536) % 2048, bl_code % 256)
        ant1, ant2 = a1 - 1, a2 - 1
    else:
        a1 = par('ANTENNA1', required=False)
        a2 = par('ANTENNA2', required=False)
        if a1 is None or a2 is None:
            raise ValueError("no BASELINE or ANTENNA1/ANTENNA2 group "
                             f"parameters (PTYPEs: {ptypes})")
        ant1 = np.round(a1).astype(np.int64) - 1
        ant2 = np.round(a2).astype(np.int64) - 1
    jd = par('DATE')

    # multi-setup / multi-source files need per-group table dereferencing
    freqsel = 1
    for ptype, what in (('FREQSEL', 'frequency setups'),
                        ('SOURCE', 'sources')):
        vals = par(ptype, required=False)
        if vals is None:
            continue
        uniq = np.unique(np.round(vals))
        if uniq.size > 1:
            raise ValueError(
                f"multiple {what} in one file are not supported "
                f"({ptype} takes {uniq.size} values)")
        if ptype == 'FREQSEL' and uniq.size:
            # a CONSTANT non-1 FREQSEL is fine — it just keys which FQ
            # row describes the data (multi-setup FQ, one setup used)
            freqsel = int(uniq[0])

    # regular axes located by CTYPE, any order
    ctypes = {str(hdr.get(f'CTYPE{i}', '')).strip(): i
              for i in range(2, int(hdr['NAXIS']) + 1)}
    n_per_ax = {i: naxes[i - 1] for i in range(2, int(hdr['NAXIS']) + 1)}
    i_freq = ctypes.get('FREQ')
    if i_freq is None:
        raise ValueError(f"no FREQ axis (CTYPEs: {sorted(ctypes)})")
    i_cplx = ctypes.get('COMPLEX')
    if i_cplx is None:
        raise ValueError(f"no COMPLEX axis (CTYPEs: {sorted(ctypes)})")
    n_cplx = n_per_ax[i_cplx]
    if n_cplx not in (2, 3):
        raise ValueError(f"COMPLEX axis length {n_cplx} not in (2, 3)")
    i_stok = ctypes.get('STOKES')
    n_stok = n_per_ax.get(i_stok, 1) if i_stok else 1
    i_if = ctypes.get('IF')
    n_if = n_per_ax.get(i_if, 1) if i_if else 1
    n_chan = n_per_ax[i_freq]

    # every remaining axis (RA, DEC, ...) must be degenerate
    for name, i in ctypes.items():
        if i not in (i_freq, i_cplx, i_stok, i_if) and n_per_ax[i] != 1:
            raise ValueError(f"non-degenerate {name} axis "
                             f"(length {n_per_ax[i]}) is not supported")

    # data C-order = FITS axes reversed; FITS axis k (k >= 2) is C axis
    # nax-(k-1) of the per-group shape, +1 for the leading group axis
    shape = tuple(reversed(naxes[1:]))
    nax = len(shape)
    dat = flat[:, pcount:].reshape((gcount,) + shape).astype(np.float64)

    def c_axis(fits_axis):
        return 1 + (nax - (fits_axis - 1))
    move_from = [c_axis(i_cplx), c_axis(i_freq)]
    move_to = [-1, -2]
    if i_stok:
        move_from.append(c_axis(i_stok))
        move_to.append(-3)
    if i_if:
        move_from.append(c_axis(i_if))
        move_to.append(-4)
    dat = np.moveaxis(dat, move_from, move_to)
    dat = dat.reshape(gcount, n_if, n_stok, n_chan, n_cplx)
    if n_cplx == 2:     # re, im only: unit weights
        dat = np.concatenate([dat, np.ones_like(dat[..., :1])], axis=-1)

    # stokes combination per IF, then stack IFs onto the channel axis
    stokes_codes = (np.round(
        float(hdr.get(f'CRVAL{i_stok}', 1.0)) +
        (np.arange(n_stok) - (float(hdr.get(f'CRPIX{i_stok}', 1.0)) - 1.0))
        * float(hdr.get(f'CDELT{i_stok}', 1.0))).astype(int)
        if i_stok else np.array([1]))
    dat = _combine_stokes(
        dat.reshape(gcount * n_if, n_stok, n_chan, 3), stokes_codes
    ).reshape(gcount, n_if, n_chan, 3)

    # channel frequencies; multi-IF needs the FQ table's offsets
    crval = float(hdr[f'CRVAL{i_freq}'])
    crpix = float(hdr.get(f'CRPIX{i_freq}', 1.0))
    cdelt = float(hdr.get(f'CDELT{i_freq}', 1.0))
    chan_off = np.arange(n_chan) - (crpix - 1.0)
    if 'AIPS FQ' in exts and exts['AIPS FQ'][1]:
        # the FQ table governs whenever present — its IF FREQ offsets
        # apply to single-IF data too (a single-IF multi-setup file
        # must not silently get the reference-setup frequencies)
        fq = exts['AIPS FQ'][1]
        try:
            if_freq_all = np.atleast_2d(np.asarray(fq['IF FREQ'],
                                                   np.float64))
            ch_width_all = np.atleast_2d(np.asarray(fq['CH WIDTH'],
                                                    np.float64))
        except (KeyError, IndexError) as e:
            raise ValueError(f"AIPS FQ table is missing column {e}")
        n_fq = if_freq_all.shape[0]
        # the (constant) FREQSEL group parameter keys the FRQSEL
        # column, NOT row order; a missing/unmatched setup must raise,
        # never silently fall back to row 0 — even for one-row tables
        sel = fq.get('FRQSEL')
        if sel is not None:
            sel = np.round(np.asarray(sel, np.float64)).astype(
                int).reshape(-1)
            rows = np.nonzero(sel == freqsel)[0]
            if rows.size != 1:
                raise ValueError(
                    f"AIPS FQ table has {rows.size} rows with "
                    f"FRQSEL={freqsel}; expected exactly one")
            r = int(rows[0])
        elif n_fq == 1 and freqsel == 1:
            r = 0               # bare minimal single-setup table
        else:
            raise ValueError(
                f"AIPS FQ table has {n_fq} setups but no FRQSEL "
                "column to match the FREQSEL group parameter "
                f"({freqsel})")
        if_freq = if_freq_all[r]
        ch_width = ch_width_all[r]
        sb_col = fq.get('SIDEBAND')
        sideband = (np.atleast_2d(np.asarray(sb_col, np.float64))[r]
                    if sb_col is not None else np.ones(n_if))
        for nm, col in (('IF FREQ', if_freq), ('CH WIDTH', ch_width),
                        ('SIDEBAND', sideband)):
            if col.size != n_if:
                raise ValueError(f"AIPS FQ column {nm} describes "
                                 f"{col.size} IFs, data has {n_if}")
        # AIPS convention: CH WIDTH is positive, SIDEBAND signs it.  A
        # zero CH WIDTH falls back to the header CDELT — as |CDELT| when
        # a SIDEBAND column is present (the sideband signs the step, and
        # LSB writers may have signed CDELT itself: applying both would
        # flip the channel ordering back to USB), raw signed CDELT when
        # there is no SIDEBAND column to do the signing
        fallback = abs(cdelt) if sb_col is not None else cdelt
        step = np.where(ch_width == 0.0, fallback, ch_width) * \
            np.where(sideband == 0.0, 1.0, sideband)
        freqs = (crval + if_freq[:, None] +
                 chan_off[None, :] * step[:, None]).reshape(-1)
    elif n_if == 1:
        freqs = crval + chan_off * cdelt
    else:
        raise ValueError(f"{n_if} IFs but no AIPS FQ table: per-IF "
                         "frequencies are undefined")
    dat = dat.reshape(gcount, n_if * n_chan, 3)

    out = {
        'uvw': uvw, 'ant1': ant1, 'ant2': ant2, 'jd': jd,
        'vis_re': dat[:, :, 0].T.copy(),
        'vis_im': dat[:, :, 1].T.copy(),
        'weights': dat[:, :, 2].T.copy(),
        'freqs': freqs,
        'n_if': n_if,
        'stokes': [_STOKES_NAMES.get(int(c), str(int(c)))
                   for c in stokes_codes],
        'ra_deg': float(hdr.get('OBSRA', hdr.get(f'CRVAL{ctypes.get("RA", 0)}', 0.0)
                                if 'RA' in ctypes else 0.0)),
        'dec_deg': float(hdr.get('OBSDEC', hdr.get(f'CRVAL{ctypes.get("DEC", 0)}', 0.0)
                                 if 'DEC' in ctypes else 0.0)),
        'source': str(hdr.get('OBJECT', '')),
        'ant_xyz': np.zeros((0, 3)), 'ant_names': [],
    }

    if 'AIPS AN' in exts:
        an = exts['AIPS AN'][1]
        if 'STABXYZ' in an and 'ANNAME' in an:
            # per the AN convention STABXYZ is relative to ARRAYX/Y/Z
            ahdr = exts['AIPS AN'][0]
            centre = np.array([float(ahdr.get(k, 0.0))
                               for k in ('ARRAYX', 'ARRAYY', 'ARRAYZ')])
            xyz = np.asarray(an['STABXYZ'], np.float64) + centre
            names = list(an['ANNAME'])
            # BASELINE codes reference NOSTA station numbers, which real
            # files may list out of order or with gaps: scatter rows to
            # index NOSTA-1 so ant1/ant2 index ant_xyz directly
            if 'NOSTA' in an and len(an['NOSTA']):
                nosta = np.asarray(an['NOSTA'], np.int64).ravel()
                if nosta.min() < 1:
                    # NOSTA is 1-relative (AIPS memo 117); a 0-based
                    # writer would otherwise scatter station 0 into the
                    # LAST slot via the -1 index, silently shifting
                    # every antenna's position
                    raise ValueError(
                        "AIPS AN table has NOSTA station numbers < 1 "
                        f"(min {int(nosta.min())}); NOSTA is 1-relative")
                size = int(nosta.max())
                full_xyz = np.full((size, 3), np.nan)
                full_names = [''] * size
                for k, st in enumerate(nosta):
                    full_xyz[st - 1] = xyz[k]
                    full_names[st - 1] = names[k]
                xyz, names = full_xyz, full_names
            out['ant_xyz'] = xyz
            out['ant_names'] = names
    return out
