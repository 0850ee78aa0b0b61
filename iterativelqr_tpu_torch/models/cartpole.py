"""Cartpole swing-up, an extra model family beyond the reference examples,
with control-limit inequality constraints on a 4-state system.

Counterpart of ``iterativelqr_tpu/models/cartpole.py``: RK2 midpoint step
h = 0.05; stage inequality rows -u_limit <= u <= u_limit; terminal equality
(x0, sin((theta - pi) / 2), xd, thetad) = 0.  The stage cost and constraint
are module-level functions bound to one problem's ``Parameters`` with
``functools.partial``, so that the line-search kernels can recognise them
(``ops/sl_forward_kernel.py``); their device counterparts are in
``csrc/sl_model_cartpole.cuh``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..core.spec import Constraint, Cost, Dynamics

NUM_STATE = 4
NUM_ACTION = 1

MASS_CART = 1.0
MASS_POLE = 0.2
LENGTH = 0.5
GRAVITY = 9.81


def cartpole_continuous(x, u):
    th, xd, thd = x[1], x[2], x[3]
    f = u[0]
    s, c = torch.sin(th), torch.cos(th)
    total = MASS_CART + MASS_POLE
    tmp = (f + MASS_POLE * LENGTH * thd**2 * s) / total
    thdd = (GRAVITY * s - c * tmp) / (
        LENGTH * (4.0 / 3.0 - MASS_POLE * c**2 / total)
    )
    xdd = tmp - MASS_POLE * LENGTH * thdd * c / total
    return torch.stack([xd, thd, xdd, thdd])


def cartpole_discrete(x, u, h=0.05):
    return x + h * cartpole_continuous(x + 0.5 * h * cartpole_continuous(x, u), u)


@dataclasses.dataclass(frozen=True)
class Parameters:
    """One cartpole problem's control limit and shaping weight, as Python
    floats."""

    u_limit: float
    shaping_weight: float

    def flat(self) -> tuple:
        """The floats in the order of ``csrc/sl_model_cartpole.cuh``."""
        return (self.u_limit, self.shaping_weight)


def stage_cost(x, u, *, p: Parameters):
    return (0.01 * torch.dot(u, u)
            + 0.1 * torch.dot(x[2:], x[2:])
            + p.shaping_weight * (1.0 + torch.cos(x[1]))
            + 0.1 * x[0] ** 2)


def terminal_cost(x, u):
    return 0.1 * torch.dot(x[2:], x[2:])


def stage_constraint(x, u, *, p: Parameters):
    return torch.stack([-p.u_limit - u[0], u[0] - p.u_limit])


def terminal_constraint(x, u):
    return torch.stack([x[0], torch.sin((x[1] - math.pi) / 2.0), x[2], x[3]])


def problem(T: int = 101, u_limit: float = 10.0, shaping_weight: float = 5.0,
            *, device="cuda"):
    """Swing-up to the upright (any winding of theta = pi); the terminal
    angle constraint is the wrapped form sin((theta - pi)/2) = 0, and the
    stage cost shapes toward upright via 1 + cos(theta) (the JAX module
    gives the reasons).  x1 and xT in float64 on ``device``."""
    p = Parameters(u_limit=float(u_limit), shaping_weight=float(shaping_weight))
    xT = torch.tensor([0.0, math.pi, 0.0, 0.0], dtype=torch.float64,
                      device=device)

    dyn = Dynamics(cartpole_discrete, NUM_STATE, NUM_ACTION)
    dynamics = [dyn] * (T - 1)

    stage = Cost(functools.partial(stage_cost, p=p), NUM_STATE, NUM_ACTION)
    term = Cost(terminal_cost, NUM_STATE, 0)
    objective = [stage] * (T - 1) + [term]

    limits = Constraint(functools.partial(stage_constraint, p=p), NUM_STATE,
                        NUM_ACTION, indices_inequality=[0, 1])
    goal = Constraint(terminal_constraint, NUM_STATE, 0)
    constraints = [limits] * (T - 1) + [goal]

    x1 = torch.zeros(NUM_STATE, dtype=torch.float64, device=device)
    return dynamics, objective, constraints, x1, xT


def swingup_controls(T):
    """Energy-pumping warm-start controls u(t) = sin(2 pi t / 50), a numpy
    [T-1, 1] array (the JAX module records the measured comparison with
    constant controls)."""
    t = np.arange(T - 1, dtype=np.float64)
    return np.sin(2.0 * np.pi * t / 50.0)[:, None] * np.ones((1, NUM_ACTION))
