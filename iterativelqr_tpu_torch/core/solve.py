"""Solve result container.

Counterpart of ``Solution`` in ``iterativelqr_tpu/core/solve.py``.  The
per-instance solver of that module (``make_solve_fn``) is not ported yet
(ROADMAP M10); the batched SL solver (``core/solve_sl.py``) returns this
container with a leading batch axis on every field.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Solution:
    """Result of a solve (padded tensors; see ProblemSpec masks)."""

    xs: torch.Tensor  # [T, nx] nominal states
    us: torch.Tensor  # [T-1, nu] nominal actions
    K: torch.Tensor  # [T-1, nu, nx] feedback gains
    k: torch.Tensor  # [T-1, nu] feedforward
    objective: torch.Tensor  # final (augmented) objective
    gradient_norm: torch.Tensor  # inf-norm of the Lagrangian gradient
    max_violation: torch.Tensor  # inf-norm constraint violation
    status: torch.Tensor  # last line search succeeded
    iterations: torch.Tensor  # total inner iterations
    al_iterations: torch.Tensor  # outer dual updates performed
    step_size: torch.Tensor  # last accepted step size
    duals: torch.Tensor  # [T, nc]
    penalty: torch.Tensor  # [T, nc]
    reg: torch.Tensor  # final regularization carry
    # traces: [max_dual_updates, max_iterations]; valid where trace_mask
    trace_cost: torch.Tensor
    trace_gradient_norm: torch.Tensor
    trace_violation: torch.Tensor
    trace_step_size: torch.Tensor
    trace_mask: torch.Tensor
    # the constraint tolerance the solve ran with
    tol_constraint: torch.Tensor

    @property
    def converged(self):
        return self.max_violation <= self.tol_constraint
