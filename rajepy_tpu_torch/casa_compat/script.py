"""CASA script collection and execution (reference: casa/_interface.py:9-81).

``Script`` collects task objects, always prepending the e-MERLIN Gaussian
primary-beam registration the reference installs on every script
(_interface.py:17-27), writes a timestamped executable ``.py`` file and —
when not a dry run and a ``casa`` binary exists on PATH — invokes
``casa --nogui --nologger --agg --logfile <log> -c <script>``.
"""
from __future__ import annotations

import os
import shutil as _shutil
import subprocess
import time
from collections.abc import Iterable

from .tasks import AddGaussPBresponse


class Script:
    """An ordered collection of CASA tasks rendered to a runnable script."""

    def __init__(self):
        self._tasklist = []

        # e-MERLIN primary-beam registration (_interface.py:17-27):
        # Gaussian PB with FWHM ~ 1.71768e10 / (nu_Hz * D_m) degrees
        fwhm_str = '{:.3f}deg'.format(1.71768e10 / (1e9 * 25.0))
        maxrad_str = '{:.3f}deg'.format(3.43537e10 / (1e9 * 25.0))
        self.add_task(AddGaussPBresponse(telescope='MERLIN2',
                                         halfwidth=fwhm_str,
                                         maxrad=maxrad_str,
                                         reffreq='1GHz'))

        prefix = time.strftime("%d%m%Y_%H%M%S", time.localtime())
        self._logfile = prefix + '.log'
        self._casafile = prefix + '.py'

    @property
    def tasklist(self):
        return self._tasklist

    @tasklist.setter
    def tasklist(self, new_tasklist):
        self._tasklist = new_tasklist

    def add_task(self, new_task):
        if isinstance(new_task, Iterable):
            self._tasklist.extend(new_task)
        else:
            self._tasklist.append(new_task)

    @property
    def logfile(self) -> str:
        return self._logfile

    @property
    def casafile(self) -> str:
        return self._casafile

    def render(self) -> str:
        """The script text (imports + one rendered call per task)."""
        lines = ['import os', 'import shutil']
        lines += [str(task) for task in self._tasklist]
        return '\n'.join(lines) + '\n'

    def execute(self, dcy: str = None, dryrun: bool = False):
        """Write the script into ``dcy`` and run it with CASA.  With
        ``dryrun`` (or no casa binary on PATH) the command and script
        contents are printed instead — the reference's only fake-backend
        mechanism (_interface.py:71-77, SURVEY §4)."""
        dcy = dcy or os.getcwd()
        script_path = os.path.join(dcy, self.casafile)
        log_path = os.path.join(dcy, self.logfile)
        with open(script_path, 'a+') as f:
            f.write(self.render())

        cmd = (f"casa --nogui --nologger --agg --logfile {log_path} "
               f"-c {script_path}")
        if dryrun or _shutil.which('casa') is None:
            print(cmd)
            print(f"Contents of {script_path}:")
            with open(script_path, 'rt') as f:
                print(f.read())
            return None
        return subprocess.run(cmd, shell=True, cwd=dcy)
