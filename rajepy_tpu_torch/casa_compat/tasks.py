"""Typed CASA task wrappers (reference: casa/tasks.py:12-502).

Each task declares ``PARAMS = {name: (type-or-types, default)}``; setting a
parameter type-checks against the declaration and ``str(task)`` renders the
CASA call with only the parameters that differ from their defaults (the
rendering contract of tasks.py:84-132).  Positional pseudo-tasks (os/shutil
calls emitted into the script, tasks.py:320-357) use integer keys.
"""
from __future__ import annotations

import copy as _copy
from typing import Dict, Tuple


class CasaTask:
    """Base task: parameter registry + type checking + rendering."""

    NAME: str = ''
    PARAMS: Dict = {}

    def __init__(self, *args, **kwargs):
        # deep-copy mutable defaults (lists/dicts): aliasing the class-
        # level PARAMS objects would let task.params['scales'].extend(...)
        # corrupt the shared default for every instance AND defeat the
        # default-omission rendering (the value would compare equal to
        # itself)
        self._values = {k: _copy.deepcopy(v)
                        for k, (_, v) in self.PARAMS.items()}
        self.set_vals(*args, **kwargs)

    def set_vals(self, *args, **kwargs):
        """Type-checked parameter assignment (tasks.py:146-173)."""
        for i, val in enumerate(args, start=1):
            kwargs[i] = val
        for key, val in kwargs.items():
            if key not in self.PARAMS:
                raise KeyError(
                    f"{key!r} is not a parameter of CASA task {self.NAME}")
            expected = self.PARAMS[key][0]
            if not isinstance(val, expected):
                raise TypeError(
                    f"parameter {key!r} of {self.NAME} must be of type "
                    f"{expected}, not {type(val)}")
            self._values[key] = val

    @property
    def taskname(self) -> str:
        return self.NAME

    @property
    def params(self) -> Dict:
        return dict(self._values)

    def __str__(self) -> str:
        """Render the call, omitting defaulted parameters
        (tasks.py:84-132)."""
        pos = [repr(self._values[k]) for k in sorted(
            k for k in self._values if isinstance(k, int))]
        kw = [f"{k}={self._values[k]!r}"
              for k in self._values
              if isinstance(k, str) and
              self._values[k] != self.PARAMS[k][1]]
        return f"{self.NAME}({', '.join(pos + kw)})"


class Simobserve(CasaTask):
    """Synthetic measurement sets from a model image (tasks.py:176-213)."""
    NAME = 'simobserve'
    PARAMS = {
        'project': (str, ''), 'skymodel': (str, ''), 'incenter': (str, ''),
        'inwidth': (str, ''), 'complist': (str, ''),
        'setpointings': (bool, False), 'ptgfile': (str, ''),
        'integration': (str, '5s'), 'direction': (str, ''),
        'mapsize': (list, ['', '']), 'maptype': (str, 'ALMA'),
        'pointingspacing': (str, ''), 'obsmode': (str, 'int'),
        'antennalist': (str, ''), 'refdate': (str, ''),
        'hourangle': (str, 'transit'), 'totaltime': (str, ''),
        'caldirection': (str, ''), 'calflux': (str, '1Jy'),
        'outframe': (str, 'LSRK'), 'thermalnoise': (str, 'tsys-atm'),
        'user_pwv': (float, 1.0), 't_ground': (float, 269.0),
        'seed': (int, 11111), 'leakage': (float, 0.0),
        'graphics': (str, 'none'), 'verbose': (bool, True),
        'overwrite': (bool, False),
    }


class Tclean(CasaTask):
    """Imaging/deconvolution of a measurement set (tasks.py:215-277)."""
    NAME = 'tclean'
    PARAMS = {
        'vis': (str, ''), 'selectdata': (bool, False), 'field': (str, ''),
        'spw': (str, ''), 'timerange': (str, ''), 'uvrange': (str, ''),
        'antenna': (str, ''), 'scan': (str, ''), 'observation': (str, ''),
        'intent': (str, ''), 'datacolumn': (str, 'data'),
        'imagename': (str, ''), 'imsize': (list, [100, 100]),
        'cell': (list, ['0.1arcsec']), 'phasecenter': (str, ''),
        'stokes': (str, 'I'), 'projection': (str, 'TAN'),
        'startmodel': (str, ''), 'specmode': (str, 'mfs'),
        'restfreq': (list, ['']), 'reffreq': (str, ''),
        'gridder': (str, 'standard'), 'vptable': (str, ''),
        'pblimit': (float, 0.2), 'deconvolver': (str, 'clark'),
        'scales': (list, []), 'smallscalebias': (float, 0.0),
        'nterms': (int, 1), 'restoration': (bool, True),
        'restoringbeam': (list, []), 'pbcor': (bool, False),
        'outlierfile': (str, ''), 'weighting': (str, 'briggs'),
        'robust': (float, 0.5), 'npixels': (int, 0), 'uvtaper': (list, []),
        'niter': (int, 1000), 'gain': (float, 0.1),
        'threshold': (float, 0.0), 'nsigma': (float, 3.0),
        'cycleniter': (int, -1), 'cyclefactor': (float, 1.0),
        'minpsffraction': (float, 0.05), 'maxpsffraction': (float, 0.8),
        'interactive': (bool, False), 'usemask': (str, 'user'),
        'mask': (str, ''), 'pbmask': (float, 0.0), 'restart': (bool, False),
        'savemodel': (str, 'none'), 'calcres': (bool, True),
        'calcpsf': (bool, True), 'parallel': (bool, False),
    }


class Exportfits(CasaTask):
    """CASA image -> FITS (tasks.py:279-299)."""
    NAME = 'exportfits'
    PARAMS = {
        'imagename': (str, ''), 'fitsimage': (str, ''),
        'velocity': (bool, False), 'optical': (bool, False),
        'bitpix': (int, -32), 'minpix': (int, 0), 'maxpix': (int, -1),
        'overwrite': (bool, False), 'dropstokes': (bool, False),
        'stokeslast': (bool, True), 'history': (bool, True),
        'dropdeg': (bool, False),
    }


class Concat(CasaTask):
    """Measurement-set concatenation (tasks.py:301-318)."""
    NAME = 'concat'
    PARAMS = {
        'vis': (list, ['']), 'concatvis': (str, ''), 'freqtol': (str, ''),
        'dirtol': (str, ''), 'respectname': (bool, False),
        'timesort': (bool, False), 'copypointing': (bool, True),
        'visweightscale': (list, []), 'forcesingleephemfield': (str, ''),
    }


class Imfit(CasaTask):
    """2-D Gaussian image fitting (tasks.py:359-387)."""
    NAME = 'imfit'
    PARAMS = {
        'imagename': (str, ''), 'box': (str, ''), 'region': (str, ''),
        'chans': (str, ''), 'stokes': (str, ''), 'mask': (str, ''),
        'includepix': (list, []), 'excludepix': (list, []),
        'residual': (str, ''), 'model': (str, ''), 'estimates': (str, ''),
        'logfile': (str, ''), 'append': (bool, True),
        'newestimates': (str, ''), 'complist': (str, ''),
        'overwrite': (bool, False), 'dooff': (bool, False),
        'offset': (float, 0.0), 'fixoffset': (bool, False),
        'stretch': (bool, False), 'rms': (float, -1.0),
        'noisefwhm': (str, ''), 'summary': (str, ''),
    }


class Immath(CasaTask):
    """Image arithmetic (tasks.py:389-411)."""
    NAME = 'immath'
    PARAMS = {
        'imagename': (str, ''), 'mode': (str, 'evalexpr'),
        'outfile': (str, ''), 'expr': (str, ''), 'varnames': (str, ''),
        'sigma': (str, '0.0mJy/beam'), 'mask': (str, ''),
        'region': (str, ''), 'box': (str, ''), 'chans': (str, ''),
        'stokes': (str, ''), 'imagemd': (str, ''), 'prec': (str, 'float'),
    }


class IaClose(CasaTask):
    """Close CASA's image-analysis (ia) tool (tasks.py:413-421)."""
    NAME = 'ia.close'
    PARAMS: Dict = {}


class IaMaskhandler(CasaTask):
    """Set/delete/copy masks of an ia-attached image (tasks.py:424-430)."""
    NAME = 'ia.maskhandler'
    PARAMS = {'op': (str, 'default'), 'name': ((str, list), [])}


class IaOpen(CasaTask):
    """Attach the ia tool to an image (tasks.py:433-442)."""
    NAME = 'ia.open'
    PARAMS = {'infile': (str, ''), 'cache': (bool, True)}


class IaPad(CasaTask):
    """Pad an ia-attached image by npixels per side (tasks.py:445-463)."""
    NAME = 'ia.pad'
    PARAMS = {
        'outfile': (str, ''), 'npixels': (int, 1), 'value': (int, 0),
        'padmask': (bool, False), 'overwrite': (bool, False),
        'region': (str, ''), 'box': (str, ''), 'chans': (str, ''),
        'stokes': (str, ''), 'mask': (str, ''), 'stretch': (bool, False),
        'wantreturn': (bool, True),
    }


class IaRestoringbeam(CasaTask):
    """Get the restoring beam(s) of an ia-attached image
    (tasks.py:466-477)."""
    NAME = 'ia.restoringbeam'
    PARAMS = {'channel': (int, -1), 'polarization': (int, -1)}


class Chdir(CasaTask):
    """os.chdir emitted into the script (tasks.py:320-331)."""
    NAME = 'os.chdir'
    PARAMS = {1: (str, '')}


class Mkdir(CasaTask):
    """os.makedirs emitted into the script (tasks.py:333-345)."""
    NAME = 'os.makedirs'
    PARAMS = {'name': (str, '')}


class Rmdir(CasaTask):
    """shutil.rmtree emitted into the script (tasks.py:347-357)."""
    NAME = 'shutil.rmtree'
    PARAMS = {'path': (str, '')}


class AddGaussPBresponse(CasaTask):
    """Register a Gaussian primary-beam response for an out-of-repository
    telescope via the vp tool (tasks.py:479-502; prepended to every script
    by the reference for e-MERLIN at casa/_interface.py:17-27)."""
    NAME = 'vp.setpbgauss'
    PARAMS = {
        'telescope': (str, 'OTHER'), 'othertelescope': (str, ''),
        'halfwidth': (str, '0.5deg'), 'maxrad': (str, '1.0deg'),
        'reffreq': (str, '1.0GHz'), 'dopb': (bool, True),
        'isthispb': (str, 'PB'),
        'squintdir': (dict, {'m0': {'unit': 'rad', 'value': 0.0},
                             'm1': {'unit': 'rad', 'value': 0.0},
                             'refer': 'J2000', 'type': 'direction'}),
        'squintreffreq': (dict, {'unit': 'GHz', 'value': 1.0}),
        'dosquint': (bool, False),
        'paincrement': (dict, {'unit': 'deg', 'value': 720.0}),
        'usesymmetricbeam': (bool, False),
    }
