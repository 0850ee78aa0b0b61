"""Unicycle car with obstacle avoidance (reference: examples/car.jl,
test/car.jl).

Counterpart of ``iterativelqr_tpu/models/car.py``: T=51, 3 states, 2
actions; control box + circular-obstacle inequality constraints at each
stage, terminal goal equality + obstacle inequality.  The stage functions
are module-level functions bound to one problem's ``Parameters`` with
``functools.partial``, so that the line-search kernels can recognise them
(``ops/sl_forward_kernel.py``); their device counterparts are in
``csrc/sl_model_car.cuh``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.spec import Constraint, Cost, Dynamics
from ._const import const_like, floats

NUM_STATE = 3
NUM_ACTION = 2


def car_continuous(x, u):
    return torch.stack([u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]), u[1]])


def car_discrete(x, u, h=0.1):
    # explicit midpoint (RK2), reference: examples/car.jl:25-28
    return x + h * car_continuous(x + 0.5 * h * car_continuous(x, u), u)


@dataclasses.dataclass(frozen=True)
class Parameters:
    """One car problem's goal, control box and obstacle, as Python floats.
    ``obstacle_radius_sq`` is ``r_obs**2`` formed in Python float and cast
    at use, as the JAX model forms it."""

    x_goal: tuple
    u_lower: tuple
    u_upper: tuple
    obstacle_center: tuple
    obstacle_radius_sq: float

    def flat(self) -> tuple:
        """The floats in the order of ``csrc/sl_model_car.cuh``."""
        return (self.x_goal + self.u_lower + self.u_upper
                + self.obstacle_center + (self.obstacle_radius_sq,))


def stage_cost(x, u, *, p: Parameters):
    d = x - const_like(p.x_goal, x)
    return torch.dot(d, d) + 1.0e-2 * torch.dot(u, u)


def terminal_cost(x, u, *, p: Parameters):
    d = x - const_like(p.x_goal, x)
    return 1000.0 * torch.dot(d, d)


def _obstacle(x, p: Parameters):
    e = x[:2] - const_like(p.obstacle_center, x)
    return (p.obstacle_radius_sq - torch.dot(e, e)).reshape(1)


def stage_constraint(x, u, *, p: Parameters):
    return torch.cat([
        const_like(p.u_lower, x) - u,   # control lower bound
        u - const_like(p.u_upper, x),   # control upper bound
        _obstacle(x, p),                # obstacle
    ])


def terminal_constraint(x, u, *, p: Parameters):
    return torch.cat([
        x - const_like(p.x_goal, x),    # goal equality
        _obstacle(x, p),                # obstacle
    ])


def problem(
    T: int = 51,
    x_goal=(1.0, 1.0, 0.0),
    u_lower=-5.0,
    u_upper=5.0,
    obstacle_center=(0.5, 0.5),
    obstacle_radius=0.1,
):
    p = Parameters(
        x_goal=floats(x_goal, NUM_STATE),
        u_lower=floats(u_lower, NUM_ACTION),
        u_upper=floats(u_upper, NUM_ACTION),
        obstacle_center=floats(obstacle_center, 2),
        obstacle_radius_sq=float(obstacle_radius) ** 2,
    )
    xT = torch.tensor(p.x_goal, dtype=torch.float64)

    dyn = Dynamics(car_discrete, NUM_STATE, NUM_ACTION)
    dynamics = [dyn] * (T - 1)

    stage_cost_p = Cost(functools.partial(stage_cost, p=p), NUM_STATE, NUM_ACTION)
    term_cost_p = Cost(functools.partial(terminal_cost, p=p), NUM_STATE, 0)
    objective = [stage_cost_p] * (T - 1) + [term_cost_p]

    stage = Constraint(functools.partial(stage_constraint, p=p), NUM_STATE,
                       NUM_ACTION, indices_inequality=range(5))
    term = Constraint(functools.partial(terminal_constraint, p=p), NUM_STATE,
                      NUM_ACTION, indices_inequality=[3])
    constraints = [stage] * (T - 1) + [term]

    x1 = torch.zeros(NUM_STATE, dtype=torch.float64)
    return dynamics, objective, constraints, x1, xT


def initial_controls(T: int = 51):
    """Reference initialization u_t = 1e-2 * [1, 0.1] (examples/car.jl:36)."""
    return [torch.tensor([1.0e-2, 1.0e-3], dtype=torch.float64)] * (T - 1)
