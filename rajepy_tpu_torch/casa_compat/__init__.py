"""CASA script-export compatibility layer (a copy of
rajepy_tpu.casa_compat).

The framework's synthetic observations run natively on device
(:mod:`rajepy_tpu_torch.synthobs`) — no CASA required.  This module
preserves the *scripting* capability of the reference's casa/ package
(SURVEY §2.8) for users who want to drive a real CASA installation with
the same sky models: typed task wrappers (tasks.py:12-502) that render ``task(param=value, ...)``
calls omitting defaulted parameters, and a :class:`Script` collector
(casa/_interface.py:9-81) that writes an executable CASA python script and,
when a ``casa`` binary is on PATH, runs it with the reference's exact
invocation flags.
"""
from .tasks import (AddGaussPBresponse, Chdir, Concat, Exportfits, IaClose,
                    IaMaskhandler, IaOpen, IaPad, IaRestoringbeam, Imfit,
                    Immath, Mkdir, Rmdir, Simobserve, Tclean)
from .script import Script

__all__ = ['Script', 'Simobserve', 'Tclean', 'Exportfits', 'Concat',
           'Imfit', 'Immath', 'Chdir', 'Mkdir', 'Rmdir', 'IaClose',
           'IaMaskhandler', 'IaOpen', 'IaPad', 'IaRestoringbeam',
           'AddGaussPBresponse']
