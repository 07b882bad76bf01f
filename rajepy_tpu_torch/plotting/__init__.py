"""Diagnostic plotting."""
from . import functions  # noqa: F401
