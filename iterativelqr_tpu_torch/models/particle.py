"""Double-integrator particle (reference: examples/particle.jl, README
quickstart).

Counterpart of ``iterativelqr_tpu/models/particle.py``: T=11, 2 states, 1
action, quadratic costs, terminal equality x_T = goal.  The goal
constraint is a module-level function bound to one problem's
``Parameters`` with ``functools.partial``, so that the line-search kernels
can recognise it (``ops/sl_forward_kernel.py``); the device counterparts
are in ``csrc/sl_model_particle.cuh``.  The dynamics are linear: their
Jacobians carry no state dependence (the JAX "auto" backward rule maps such
stacks unbatched; the port's derive batches every stack).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.spec import Constraint, Cost, Dynamics
from ._const import const_like, floats

NUM_STATE = 2
NUM_ACTION = 1

_A = ((1.0, 1.0), (0.0, 1.0))
_B = (0.0, 1.0)


def particle_discrete(x, u):
    return const_like(_A, x) @ x + const_like(_B, x) * u[0]


@dataclasses.dataclass(frozen=True)
class Parameters:
    """One particle problem's goal, as Python floats."""

    x_goal: tuple

    def flat(self) -> tuple:
        """The floats in the order of ``csrc/sl_model_particle.cuh``."""
        return self.x_goal


def stage_cost(x, u):
    return 0.1 * torch.dot(x, x) + 0.1 * torch.dot(u, u)


def terminal_cost(x, u):
    return 0.1 * torch.dot(x, x)


def goal_constraint(x, u, *, p: Parameters):
    return x - const_like(p.x_goal, x)


def problem(T: int = 11, x_goal=(1.0, 0.0), *, device="cuda"):
    """(dynamics, objective, constraints, x1, xT) per examples/particle.jl;
    x1 and xT in float64 on ``device``."""
    p = Parameters(x_goal=floats(x_goal, NUM_STATE))
    xT = torch.tensor(p.x_goal, dtype=torch.float64, device=device)
    dyn = Dynamics(particle_discrete, NUM_STATE, NUM_ACTION)
    dynamics = [dyn] * (T - 1)

    stage = Cost(stage_cost, NUM_STATE, NUM_ACTION)
    term = Cost(terminal_cost, NUM_STATE, 0)
    objective = [stage] * (T - 1) + [term]

    goal = Constraint(functools.partial(goal_constraint, p=p), NUM_STATE, 0)
    constraints = [Constraint() for _ in range(T - 1)] + [goal]

    x1 = torch.zeros(NUM_STATE, dtype=torch.float64, device=device)
    return dynamics, objective, constraints, x1, xT
