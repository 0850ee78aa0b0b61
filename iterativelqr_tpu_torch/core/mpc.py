"""Receding-horizon MPC on top of the per-instance solve function.

Counterpart of ``iterativelqr_tpu/core/mpc.py`` (the measured rationale of
every warm-start choice lives there).  An MPC controller is a step: shift
the previous solution one step, re-roll it closed-loop from the measured
state, re-solve warm-started (optionally carrying the AL duals and
penalties), and emit the first action.  A farm of controllers stepping in
lockstep is the same sequence over a leading lane axis with the batched
solver (``parallel/batch.py::make_batched_solve_fn(..., dual_warm_start=
True)``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..ops.rollout import closed_loop_rollout
from .options import Options
from .solve import Solution, make_solve_fn
from .spec import ProblemSpec


@dataclasses.dataclass
class MPCState:
    """Warm-start carry between MPC steps."""

    xs: torch.Tensor       # [T, nx] last solved nominal states
    us: torch.Tensor       # [T-1, nu] last solved nominal actions
    K: torch.Tensor        # [T-1, nu, nx] last solved feedback gains
    duals: torch.Tensor    # [T, nc]
    penalty: torch.Tensor  # [T, nc]


class MPCStep(NamedTuple):
    state: MPCState
    action: torch.Tensor   # [nu] first action of the re-solved plan
    solution: Solution


def _shift(a, tail=None):
    """a[1:] followed by ``tail`` (default the last row): the plan one
    step on."""
    return torch.cat([a[1:], a[-1:] if tail is None else tail], dim=0)


def make_mpc_controller(
    spec: ProblemSpec,
    options: Options = Options(),
    carry_duals: bool = True,
    carry_penalty: bool = True,
    penalty_carry_cap: float = 1.0e4,
    shift_fill: str = "repeat",  # "repeat" last action | "zero"
    step_objective_tolerance: Optional[float] = 1.0e-4,
    max_step_iterations: Optional[int] = None,
    constraint_aware: bool = True,
    *,
    device="cuda",
):
    """Build ``init(xs, us, ws=None) -> MPCState`` and ``step(state,
    x_measured, ws) -> MPCStep``, solving on ``device`` (the card unless
    the caller passes "cpu"; the dtype is the state's).

    ``carry_duals``/``carry_penalty`` shift the AL multipliers and
    penalties with the plan, the penalty capped at ``penalty_carry_cap``;
    ``step_objective_tolerance`` overrides ``options.objective_tolerance``
    for the step re-solves (None keeps it); ``max_step_iterations`` is a
    hard per-step budget of total iterations (``max_total_iterations``);
    ``constraint_aware`` turns on the constraint-aware line-search
    acceptance, which keeps the step on the loop rollouts (the rollout
    kernels do not score per-candidate violations).
    """
    if constraint_aware:
        options = dataclasses.replace(options, constraint_aware_acceptance=True)
    if step_objective_tolerance is not None:
        options = dataclasses.replace(
            options, objective_tolerance=step_objective_tolerance)
    if max_step_iterations is not None:
        options = dataclasses.replace(
            options, max_total_iterations=max_step_iterations)
    solve = make_solve_fn(spec, options, dual_warm_start=True, device=device)
    T, nx, nu, nc = spec.T, spec.nx, spec.nu, spec.nc

    def fresh_penalty(like):
        return torch.full((T, nc), options.initial_constraint_penalty,
                          dtype=like.dtype, device=like.device)

    def init(xs, us, ws=None) -> MPCState:
        return MPCState(
            xs=xs, us=us,
            K=xs.new_zeros((T - 1, nu, nx)),
            duals=xs.new_zeros((T, nc)),
            penalty=fresh_penalty(xs),
        )

    def step(state: MPCState, x_measured, ws) -> MPCStep:
        xs0 = state.xs
        tail = None if shift_fill == "repeat" else torch.zeros_like(state.us[-1:])
        us = _shift(state.us, tail)
        # re-roll the shifted plan from the measurement closed-loop around
        # the old nominal, u_t = us_t + K_t (x_t - xs_shift_t): a spliced
        # state leaves a dynamically inconsistent nominal, and an open-loop
        # re-roll diverges on unstable plants (the JAX module's measurements)
        xs, us = closed_loop_rollout(
            spec, _shift(xs0), us, ws, _shift(state.K), torch.zeros_like(us),
            0.0, x0=x_measured.to(xs0.dtype))
        if carry_duals and nc > 0:
            duals = _shift(state.duals)
        else:
            duals = xs0.new_zeros((T, nc))
        if carry_penalty and nc > 0:
            penalty = torch.minimum(
                _shift(state.penalty),
                torch.tensor(penalty_carry_cap, dtype=xs0.dtype, device=xs0.device))
        else:
            penalty = fresh_penalty(xs0)
        sol = solve(xs, us, ws, duals, penalty)
        new_state = MPCState(xs=sol.xs, us=sol.us, K=sol.K, duals=sol.duals,
                             penalty=sol.penalty)
        return MPCStep(state=new_state, action=sol.us[0], solution=sol)

    return init, step
