"""Quadrotor waypoint flight (12 states, 4 controls), a model family beyond
the reference's examples.

Counterpart of ``iterativelqr_tpu/models/quadrotor.py``: position (3), Euler
angles roll, pitch, yaw (3), velocity (3) and body angular rates (3); four
rotor thrusts; RK2 midpoint discretization with h = 0.05.  Rotor thrust
bounds are stage inequality rows; the terminal constraint is a hover at the
goal (equality, all 12 states).  The stage functions are module-level
functions bound to one problem's ``Parameters`` with ``functools.partial``,
so that the line-search kernels can recognise them
(``ops/sl_forward_kernel.py``); their device counterparts are in
``csrc/sl_model_quadrotor.cuh``.  The operations follow the JAX model's
order, with Python-float constants cast at use.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.spec import Constraint, Cost, Dynamics
from ._const import const_like, floats

NUM_STATE = 12
NUM_ACTION = 4

MASS = 1.0
GRAVITY = 9.81
ARM = 0.2          # rotor arm length
KT = 0.02          # yaw torque / thrust ratio
INERTIA = (0.01, 0.01, 0.02)
HOVER = MASS * GRAVITY / 4.0


def _cross(a, b):
    """``jnp.cross`` of two 3-vectors, in its operation order."""
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def quadrotor_continuous(x, u):
    v, w = x[6:9], x[9:12]
    roll, pitch, yaw = x[3], x[4], x[5]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)

    thrust = torch.sum(u)
    # body-z axis in world frame (ZYX Euler)
    bz = torch.stack([cy * sp * cr + sy * sr, sy * sp * cr - cy * sr, cp * cr])
    acc = bz * (thrust / MASS) - const_like((0.0, 0.0, GRAVITY), x)

    # torques from rotor layout (x-configuration)
    tau = torch.stack([
        ARM * (u[1] - u[3]),
        ARM * (u[2] - u[0]),
        KT * (u[0] - u[1] + u[2] - u[3]),
    ])
    inertia = const_like(INERTIA, x)
    wdot = (tau - _cross(w, inertia * w)) / inertia

    # Euler angle kinematics (small-angle-safe form)
    t_pitch = torch.tan(pitch)
    angdot = torch.stack([
        w[0] + sr * t_pitch * w[1] + cr * t_pitch * w[2],
        cr * w[1] - sr * w[2],
        (sr * w[1] + cr * w[2]) / cp,
    ])
    return torch.cat([v, angdot, acc, wdot])


def quadrotor_discrete(x, u, h=0.05):
    # explicit midpoint (RK2)
    return x + h * quadrotor_continuous(x + 0.5 * h * quadrotor_continuous(x, u), u)


@dataclasses.dataclass(frozen=True)
class Parameters:
    """One quadrotor problem's goal position and rotor thrust bounds, as
    Python floats (the bounds broadcast to the four rotors)."""

    goal: tuple
    u_min: tuple
    u_max: tuple

    def x_goal(self) -> tuple:
        """The terminal state: hover at the goal, every other state 0."""
        return self.goal + (0.0,) * (NUM_STATE - 3)

    def flat(self) -> tuple:
        """The floats in the order of ``csrc/sl_model_quadrotor.cuh``."""
        return self.goal + self.u_min + self.u_max


def stage_cost(x, u, *, p: Parameters):
    e = x - const_like(p.x_goal(), x)
    du = u - HOVER
    return (
        1.0 * torch.dot(e[0:3], e[0:3])
        + 0.5 * torch.dot(e[3:6], e[3:6])
        + 0.1 * torch.dot(e[6:12], e[6:12])
        + 0.05 * torch.dot(du, du)
    )


def terminal_cost(x, u, *, p: Parameters):
    e = x - const_like(p.x_goal(), x)
    return 1.0 * torch.dot(e, e)


def stage_constraint(x, u, *, p: Parameters):
    """Rotor thrust bounds: u_min - u <= 0, u - u_max <= 0."""
    return torch.cat([const_like(p.u_min, x) - u, u - const_like(p.u_max, x)])


def terminal_constraint(x, u, *, p: Parameters):
    """Hover at the goal (equality)."""
    return x - const_like(p.x_goal(), x)


def problem(
    T: int = 41,
    goal=(1.0, 1.0, 1.0),
    u_min: float = 0.0,
    u_max: float = 6.0,
):
    p = Parameters(
        goal=floats(goal, 3),
        u_min=floats(u_min, NUM_ACTION),
        u_max=floats(u_max, NUM_ACTION),
    )
    xT = torch.tensor(p.x_goal(), dtype=torch.float64)

    dyn = Dynamics(quadrotor_discrete, NUM_STATE, NUM_ACTION)
    dynamics = [dyn] * (T - 1)

    stage = Cost(functools.partial(stage_cost, p=p), NUM_STATE, NUM_ACTION)
    term = Cost(functools.partial(terminal_cost, p=p), NUM_STATE, 0)
    objective = [stage] * (T - 1) + [term]

    limits = Constraint(functools.partial(stage_constraint, p=p), NUM_STATE,
                        NUM_ACTION, indices_inequality=range(2 * NUM_ACTION))
    goal_con = Constraint(functools.partial(terminal_constraint, p=p),
                          NUM_STATE, 0)
    constraints = [limits] * (T - 1) + [goal_con]

    x1 = torch.zeros(NUM_STATE, dtype=torch.float64)
    return dynamics, objective, constraints, x1, xT


def hover_controls(T: int = 41):
    """Every rotor at hover thrust m g / 4."""
    return [torch.full((NUM_ACTION,), HOVER, dtype=torch.float64)] * (T - 1)
