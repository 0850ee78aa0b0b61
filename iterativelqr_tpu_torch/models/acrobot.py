"""Acrobot swing-up (reference: examples/acrobot.jl, test/acrobot.jl).

Counterpart of ``iterativelqr_tpu/models/acrobot.py``: 4 states (q1, q2, v1,
v2), 1 action; RK2 midpoint discretization; terminal equality constraint
x_T = (pi, 0, 0, 0).  The functions are per-instance (1-D ``x``, ``u``); the
solver batches them with ``torch.func.vmap``.  The stage functions are
module-level so that the line-search kernels can recognise them
(``ops/sl_forward_kernel.py``); their device counterparts are in
``csrc/sl_model_acrobot.cuh``.
"""

from __future__ import annotations

import math

import torch

from ..core.spec import Constraint, Cost, Dynamics
from ._const import const_like

NUM_STATE = 4
NUM_ACTION = 1

# physical parameters (reference: examples/acrobot.jl:18-30)
MASS1, MASS2 = 1.0, 1.0
INERTIA1, INERTIA2 = 0.33, 0.33
LENGTH1, LENGTH2 = 1.0, 1.0
LENGTHCOM1, LENGTHCOM2 = 0.5, 0.5
GRAVITY = 9.81
FRICTION1, FRICTION2 = 0.1, 0.1

GOAL = (math.pi, 0.0, 0.0, 0.0)


def acrobot_continuous(x, u):
    q2 = x[1]
    v1, v2 = x[2], x[3]

    # mass matrix (examples/acrobot.jl:32-41)
    a = (
        INERTIA1
        + INERTIA2
        + MASS2 * LENGTH1**2
        + 2.0 * MASS2 * LENGTH1 * LENGTHCOM2 * torch.cos(q2)
    )
    b = INERTIA2 + MASS2 * LENGTH1 * LENGTHCOM2 * torch.cos(q2)
    c = INERTIA2
    det = a * c - b * b

    # gravity torque (examples/acrobot.jl:52-60)
    tau1 = -MASS1 * GRAVITY * LENGTHCOM1 * torch.sin(x[0]) - MASS2 * GRAVITY * (
        LENGTH1 * torch.sin(x[0]) + LENGTHCOM2 * torch.sin(x[0] + q2)
    )
    tau2 = -MASS2 * GRAVITY * LENGTHCOM2 * torch.sin(x[0] + q2)

    # Coriolis (examples/acrobot.jl:62-69)
    c11 = -2.0 * MASS2 * LENGTH1 * LENGTHCOM2 * torch.sin(q2) * v2
    c12 = -MASS2 * LENGTH1 * LENGTHCOM2 * torch.sin(q2) * v2
    c21 = MASS2 * LENGTH1 * LENGTHCOM2 * torch.sin(q2) * v1

    rhs1 = -(c11 * v1 + c12 * v2) + tau1 - FRICTION1 * v1
    rhs2 = -(c21 * v1) + tau2 + u[0] - FRICTION2 * v2

    # qdd = Minv @ rhs via the 2x2 adjugate (examples/acrobot.jl:43-50)
    qdd1 = (c * rhs1 - b * rhs2) / det
    qdd2 = (-b * rhs1 + a * rhs2) / det
    return torch.stack([v1, v2, qdd1, qdd2])


def acrobot_discrete(x, u, h=0.1):
    # explicit midpoint (RK2), reference: examples/acrobot.jl:85-88
    return x + h * acrobot_continuous(x + 0.5 * h * acrobot_continuous(x, u), u)


def stage_cost(x, u):
    return 0.1 * torch.dot(x[2:4], x[2:4]) + 0.1 * torch.dot(u, u)


def terminal_cost(x, u):
    return 0.1 * torch.dot(x[2:4], x[2:4])


def goal_constraint(x, u):
    """x_T - (pi, 0, 0, 0), the goal in the input's dtype on its device."""
    return x - const_like(GOAL, x)


def problem(T: int = 51):
    xT = torch.tensor(GOAL, dtype=torch.float64)

    dyn = Dynamics(acrobot_discrete, NUM_STATE, NUM_ACTION)
    dynamics = [dyn] * (T - 1)

    stage = Cost(stage_cost, NUM_STATE, NUM_ACTION)
    term = Cost(terminal_cost, NUM_STATE, 0)
    objective = [stage] * (T - 1) + [term]

    goal = Constraint(goal_constraint, NUM_STATE, 0)
    constraints = [Constraint() for _ in range(T - 1)] + [goal]

    x1 = torch.zeros(NUM_STATE, dtype=torch.float64)
    return dynamics, objective, constraints, x1, xT
