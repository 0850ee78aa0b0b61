"""Model library (ported so far: acrobot, car, quadrotor)."""

from . import acrobot, car, quadrotor

__all__ = ["acrobot", "car", "quadrotor"]
