"""Tensor code and the hand-written kernels of the continuum main path."""
from . import astronomy, gaunt, geometry, hyp2f1, kernels, physics, \
    radtrans, rrls, voigt  # noqa: F401
