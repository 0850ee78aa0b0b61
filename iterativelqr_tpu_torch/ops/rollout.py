"""Trajectory rollouts of the per-instance solver.

Counterpart of ``iterativelqr_tpu/ops/rollout.py``: the closed-loop rollout
under u_t = ubar_t + K_t (x_t - xbar_t) + alpha k_t, as a Python loop over t
(the JAX ``lax.scan``).  Arguments are ``[..., T, dim]`` tensors whose
leading lane axes broadcast against each other and against ``alpha``: one
instance, a batch, or a batch by line-search candidates (``ops/forward.py``
scores every candidate in one rollout over ``[B, na]`` lanes).  Each step's
stage type is static, so the loop picks its function in Python where the
JAX scan switches on a traced index.  The SL solver's batch-last rollouts
(and the CUDA kernels K3/K4) are ``ops/sl_forward_kernel.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.spec import Dynamics, ProblemSpec
from . import linalg_small
from .batching import lane_eval
from .derivatives import device_constant


def _alpha_k(alpha, k_t):
    """alpha * k_t, with a tensor alpha over the lanes."""
    if torch.is_tensor(alpha):
        return alpha[..., None] * k_t
    return alpha * k_t


def closed_loop_rollout(spec: ProblemSpec, xbar, ubar, ws, K, k, alpha,
                        x0=None):
    """Roll out the policy from ``x0`` (default ``xbar[..., 0, :]``).
    Returns (xs [..., T, nx], us [..., T-1, nu])."""
    x = xbar[..., 0, :] if x0 is None else x0
    xs, us = [], []
    for t in range(spec.T - 1):
        u = (ubar[..., t, :]
             + linalg_small.matvec(K[..., t, :, :], x - xbar[..., t, :])
             + _alpha_k(alpha, k[..., t, :]))
        xn = lane_eval(spec.dyn_eval[spec.dyn_tidx[t]], x, u, ws[..., t, :])
        xs.append(x.expand(xn.shape))
        us.append(u)
        x = xn
    xs.append(x)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


def rollout_with_al_cost(spec: ProblemSpec, xbar, ubar, ws, K, k, alpha,
                         duals, penalty, cost_only: bool = False,
                         with_viol: bool = False):
    """Closed-loop rollout with the AL objective accumulated inside the loop.

    Returns (xs [..., T, nx], us [..., T-1, nu], J [...], c [..., T, nc]);
    with ``cost_only`` the trajectory is not kept and the returns are
    (None, None, J, None).  With ``with_viol`` a fifth return is the
    trajectory's max constraint violation [...] (the constraint-aware
    line-search acceptance scores candidates with it)."""
    nc = spec.nc
    device, dtype = xbar.device, xbar.dtype
    ineq = device_constant(spec.ineq_mask, device)
    cmask = device_constant(spec.c_mask, device)
    track_viol = with_viol and nc > 0

    def al_term(c_t, lam_t, rho_t, ineq_t):
        inactive = ineq_t & (c_t < 0.0) & (lam_t == 0.0)
        a = (~inactive).to(c_t.dtype)
        return (torch.sum(lam_t * c_t, dim=-1)
                + 0.5 * torch.sum(a * rho_t * c_t * c_t, dim=-1))

    def viol_of(c_t, ineq_t, cm_t):
        v = torch.where(ineq_t, torch.clamp(c_t, min=0.0), torch.abs(c_t))
        return torch.where(cm_t, v, torch.zeros_like(v)).amax(dim=-1)

    def stage(td, tg, tc):
        """The step's cost, constraints (when it has rows) and dynamics in
        one function, so the step is one lane_eval."""
        dyn, cost, con = spec.dyn_eval[td], spec.cost_eval[tg], spec.con_eval[tc]
        if has_rows[tc]:
            return lambda x, u, w: (cost(x, u, w), con(x, u, w), dyn(x, u, w))
        return lambda x, u, w: (cost(x, u, w), dyn(x, u, w))

    # a step whose constraint block is empty has c = 0 exactly, so its AL
    # term and violation are exactly 0 and are not evaluated
    has_rows = [nc > 0 and c.f is not None for c in spec.con_types]
    stages = {}
    x = xbar[..., 0, :]
    J = torch.zeros((), dtype=dtype, device=device)
    viol = torch.zeros((), dtype=dtype, device=device)
    xs, us, cs = [], [], []
    for t in range(spec.T - 1):
        u = (ubar[..., t, :]
             + linalg_small.matvec(K[..., t, :, :], x - xbar[..., t, :])
             + _alpha_k(alpha, k[..., t, :]))
        key = (spec.dyn_tidx[t], spec.cost_tidx[t], spec.con_tidx[t])
        if key not in stages:
            stages[key] = stage(*key)
        out = lane_eval(stages[key], x, u, ws[..., t, :])
        J = J + out[0]
        xn = out[-1]
        if has_rows[key[2]]:
            c_t = out[1]
            J = J + al_term(c_t, duals[..., t, :], penalty[..., t, :], ineq[t])
            if track_viol:
                viol = torch.maximum(viol, viol_of(c_t, ineq[t], cmask[t]))
        elif nc > 0:
            c_t = xn.new_zeros(xn.shape[:-1] + (nc,))
        if not cost_only:
            if nc > 0:
                cs.append(c_t)
            xs.append(x.expand(xn.shape))
            us.append(u)
        x = xn

    # terminal stage: u = 0 (terminal stage functions have num_action == 0)
    u0 = x.new_zeros(x.shape[:-1] + (spec.nu,))
    J = J + lane_eval(spec.cost_eval[spec.cost_tidx[-1]], x, u0, ws[..., -1, :])
    c = None
    if nc > 0:
        cT = lane_eval(spec.con_eval[spec.con_tidx[-1]], x, u0, ws[..., -1, :])
        J = J + al_term(cT, duals[..., -1, :], penalty[..., -1, :], ineq[-1])
        if track_viol:
            viol = torch.maximum(viol, viol_of(cT, ineq[-1], cmask[-1]))
        if not cost_only:
            c = torch.stack(cs + [cT], dim=-2)
    elif not cost_only:
        c = x.new_zeros(x.shape[:-1] + (spec.T, 0))
    xs_out = us_out = None
    if not cost_only:
        xs_out = torch.stack(xs + [x], dim=-2)
        us_out = torch.stack(us, dim=-2)
    if with_viol:
        return xs_out, us_out, J, c, viol.expand(J.shape)
    return xs_out, us_out, J, c


def open_loop_rollout(spec: ProblemSpec, x1, us, ws):
    """Open-loop rollout x_{t+1} = f_t(x_t, u_t, w_t) from x1 [..., nx]."""
    lead = x1.shape[:-1]
    zK = x1.new_zeros(lead + (spec.T - 1, spec.nu, spec.nx))
    zk = x1.new_zeros(lead + (spec.T - 1, spec.nu))
    xbar = x1.new_zeros(lead + (spec.T, spec.nx))
    xbar[..., 0, :] = x1
    xs, _ = closed_loop_rollout(spec, xbar, us, ws, zK, zk, 0.0)
    return xs


def rollout(dynamics: Sequence[Dynamics], initial_state, actions,
            parameters: Optional[Sequence] = None):
    """User-facing open-loop rollout for initialization: a list of
    per-timestep states."""
    x = torch.as_tensor(initial_state)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    states = [x]
    for t, d in enumerate(dynamics):
        w = None if parameters is None else parameters[t]
        x = torch.as_tensor(d(x, torch.as_tensor(actions[t], dtype=x.dtype,
                                                 device=x.device), w))
        states.append(x)
    return states
