"""Model library: the reference's example problems plus extras, each a
``problem()`` function (ported: every model of the JAX package)."""

from . import acrobot, car, cartpole, particle, pendulum, quadrotor

__all__ = ["acrobot", "car", "particle", "pendulum", "cartpole", "quadrotor"]
