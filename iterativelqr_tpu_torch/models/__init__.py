"""Model library (ported so far: acrobot)."""

from . import acrobot

__all__ = ["acrobot"]
