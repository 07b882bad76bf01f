"""I/O: FITS images and checkpoints."""
from . import fits  # noqa: F401
