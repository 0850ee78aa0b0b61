"""Model library (ported so far: acrobot, car)."""

from . import acrobot, car

__all__ = ["acrobot", "car"]
