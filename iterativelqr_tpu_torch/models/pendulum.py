"""Pendulum swing-up (reference: test/dynamics.jl:5-16 uses this model for
the derivative tests; the swing-up problem is an extra capability demo).

Counterpart of ``iterativelqr_tpu/models/pendulum.py``: 2 states, 1 action,
RK2 midpoint step h = 0.05, terminal equality x_T = (pi, 0).  The stage
functions are module-level so that the line-search kernels can recognise
them (``ops/sl_forward_kernel.py``); their device counterparts are in
``csrc/sl_model_pendulum.cuh``.
"""

from __future__ import annotations

import math

import torch

from ..core.spec import Constraint, Cost, Dynamics
from ._const import const_like

NUM_STATE = 2
NUM_ACTION = 1

MASS = 1.0
LENGTH = 0.5
GRAVITY = 9.81
DAMPING = 0.1

GOAL = (math.pi, 0.0)


def pendulum_continuous(x, u):
    # reference test/dynamics.jl: a simple damped pendulum
    return torch.stack([
        x[1],
        (u[0] - DAMPING * x[1] - MASS * GRAVITY * LENGTH * torch.sin(x[0]))
        / (MASS * LENGTH**2),
    ])


def pendulum_discrete(x, u, h=0.05):
    return x + h * pendulum_continuous(x + 0.5 * h * pendulum_continuous(x, u), u)


def stage_cost(x, u):
    return 0.1 * torch.dot(x[1:], x[1:]) + 0.1 * torch.dot(u, u)


def terminal_cost(x, u):
    return 0.1 * torch.dot(x[1:], x[1:])


def goal_constraint(x, u):
    """x_T - (pi, 0), the goal in the input's dtype on its device."""
    return x - const_like(GOAL, x)


def problem(T: int = 51, *, device="cuda"):
    """(dynamics, objective, constraints, x1, xT); x1 and xT in float64 on
    ``device``."""
    xT = torch.tensor(GOAL, dtype=torch.float64, device=device)

    dyn = Dynamics(pendulum_discrete, NUM_STATE, NUM_ACTION)
    dynamics = [dyn] * (T - 1)

    stage = Cost(stage_cost, NUM_STATE, NUM_ACTION)
    term = Cost(terminal_cost, NUM_STATE, 0)
    objective = [stage] * (T - 1) + [term]

    goal = Constraint(goal_constraint, NUM_STATE, 0)
    constraints = [Constraint() for _ in range(T - 1)] + [goal]

    x1 = torch.zeros(NUM_STATE, dtype=torch.float64, device=device)
    return dynamics, objective, constraints, x1, xT
