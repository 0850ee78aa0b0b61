"""Parameter sensitivities of the optimal value: dJ*/dw.

Counterpart of ``iterativelqr_tpu/ops/sensitivity.py``, which derives the
adjoint (envelope) identity: at a converged primal-dual solution the total
derivative of the optimal value with respect to the parameter trajectory
is the partial derivative of the Lagrangian

    L = sum_t [ g_t + lambda_t' c_t (+ AL penalty) ]
        + sum_t p_{t+1}' ( f_t(x_t, u_t, w_t) - x_{t+1} )

with the trajectory, duals and costates held fixed.  The costates p are the
value gradients of one backward pass at the solution, with the caller's
options (so "auto" is the associative scan on one instance).

Arguments are one instance (``xs [T, nx]``) or a batch with one leading
lane axis (``xs [B, T, nx]``): the batch's backward pass is the
per-instance solver's lane loop (``ops/backward.py``, the counterpart of
``jax.vmap`` of it), and its Lagrangian gradients are one
``torch.func.vmap`` of ``torch.func.grad``.
"""

from __future__ import annotations

import torch
from torch.func import grad, vmap

from ..core.options import Options
from ..core.spec import ProblemSpec
from . import al as al_ops
from . import derivatives as dv
from .backward import backward_pass


def costates(spec: ProblemSpec, options: Options, xs, us, ws, duals, penalty):
    """Value-function gradients [..., T, nx] at the solution (index 0 is
    not used by the adjoint identity; p[t] is dV_t/dx_t of the
    AL-augmented problem)."""
    device = xs.device
    batched = xs.ndim == 3
    if not batched:
        xs, us, ws, duals, penalty = (a[None] for a in (xs, us, ws, duals, penalty))
    fx, fu = dv.dynamics_jacobians(spec, xs, us, ws)
    gx, gu = dv.cost_gradients(spec, xs, us, ws)
    gxx, guu, gux = dv.cost_hessians(spec, xs, us, ws)
    if spec.nc > 0:
        ineq = dv.device_constant(spec.ineq_mask, device)
        c = dv.constraint_values(spec, xs, us, ws)
        cx, cu = dv.constraint_jacobians(spec, xs, us, ws)
        dgx, dgu, dgxx, dguu, dgux = al_ops.al_gradient_terms(
            c, cx, cu, duals, penalty, ineq)
        gx, gu = gx + dgx, gu + dgu
        gxx, guu, gux = gxx + dgxx, guu + dguu, gux + dgux
    reg0 = xs.new_zeros(xs.shape[0])
    _, _, _, _, p, _, _ = backward_pass(
        fx, fu, gx, gu, gxx, guu, gux, dv.device_constant(spec.u_mask, device),
        reg0, options, batched=batched)
    # p[t] for t = 0..T-2 from the recursion; the terminal costate is the
    # (AL-augmented) terminal cost gradient
    p = torch.cat([p, gx[..., -1:, :]], dim=-2)
    return p if batched else p[0]


def parameter_gradient(spec: ProblemSpec, options: Options, xs, us, ws, duals, penalty):
    """dJ*/dws [..., T, npar]: the gradient of the optimal value with
    respect to the parameter trajectory at a converged solution ``(xs, us,
    duals, penalty)``."""
    p = costates(spec, options, xs, us, ws, duals, penalty)
    ineq = dv.device_constant(spec.ineq_mask, xs.device)

    def lagrangian(ws_var, xs, us, duals, penalty, p):
        J = dv.total_cost(spec, xs, us, ws_var)
        if spec.nc > 0:
            c = dv.constraint_values(spec, xs, us, ws_var)
            J = J + al_ops.al_terms(c, duals, penalty, ineq)
        f_all = dv.dynamics_values(spec, xs, us, ws_var)    # [T-1, nx]
        # adjoint term: x_{t+1} is constant in ws, so only f_t matters
        return J + torch.sum(p[1:] * f_all)

    g = grad(lagrangian)
    if xs.ndim == 3:
        g = vmap(g)
    return g(ws, xs, us, duals, penalty, p)


def solution_parameter_gradient(spec: ProblemSpec, options: Options, solution, ws):
    """``parameter_gradient`` of a ``Solution``."""
    return parameter_gradient(spec, options, solution.xs, solution.us, ws,
                              solution.duals, solution.penalty)
