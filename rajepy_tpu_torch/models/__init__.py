"""Model layer: grids, fields, ejection machinery, JetModel, run
descriptors."""
from . import ejection, fields, grid  # noqa: F401
from .jetmodel import JetModel  # noqa: F401
from .runs import ContinuumRun, RRLRun  # noqa: F401
