"""rajepy_tpu_torch — the PyTorch/CUDA port of rajepy_tpu: radiative transfer
through ionised jets from young stellar objects, run on an NVIDIA GPU.

The package mirrors rajepy_tpu's module paths and names.  It imports
``torch`` and never ``jax`` or ``rajepy_tpu``, so it runs where JAX is not
installed.  Ported so far: ``JetModel`` (construction, the grid fill, the
free-free continuum products, the radio-recombination-line products in LTE
and non-LTE, the ordered emergent intensity, FITS products and
checkpoints), the run descriptors, ``Pipeline`` with ``execute(plot=False)``
(the run matrix, per-run FITS products under ``Day<d>/<freq|line>/``,
resume, clobber and dryrun), and the synthetic observations of continuum
runs (``synthobs``: uv tracks, visibility sampling, Briggs gridding, Hogbom
CLEAN, restoration and imfit), which ``execute(simobserve=True)`` runs.
Every Pallas kernel of rajepy_tpu has a hand-written CUDA counterpart under
``csrc/``.  Not ported yet: the synthetic observation of line cubes, the
other deconvolvers, calibration and UVFITS export, plotting, fitting, the
multi-device fan-out and the CLI.

Package layout
--------------
- ``ops``       tensor code: geometry, Reynolds physics, Gauss 2F1, van
                Hoof gaunt factors, Faddeeva/Voigt, RRL line physics,
                departure coefficients, radiative-transfer reductions and
                scans, and the kernels' wrappers beside their plain
                versions (``ops/kernels.py``)
- ``csrc``      the CUDA kernels: epoch maps, RRL maps, emergent maps
- ``models``    grid construction, field evaluation, ejection bursts,
                the ``JetModel`` API, run descriptors
- ``pipeline``  the multi-epoch, multi-frequency orchestrator
- ``synthobs``  CASA-free synthetic observations of continuum runs:
                antenna configurations and uv tracks, visibility sampling
                and noise, imaging and CLEAN, source fitting (a subpackage,
                imported where used)
- ``io``        FITS writer/reader, npz/JSON checkpoints
- ``utils``     logging, validation, profiling, misc helpers
"""
from . import constants as cnsts
from . import _config as cfg
from .utils.logger import Log
from .utils import logger
from .models.jetmodel import JetModel
from .models.runs import ContinuumRun, Pointing, RRLRun
from .pipeline import Pipeline

__version__ = "0.2.0"

__all__ = ["JetModel", "Pipeline", "ContinuumRun", "RRLRun", "Pointing",
           "Log", "logger", "cnsts", "cfg", "__version__"]
