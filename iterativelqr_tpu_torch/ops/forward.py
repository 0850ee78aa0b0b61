"""Forward pass of the per-instance solver: Armijo line search over every
candidate step size at once.

Counterpart of ``iterativelqr_tpu/ops/forward.py`` (its citations of the
reference live there).  Arguments carry a leading lane axis ``[B, ...]``;
the JAX function is the per-instance one under ``jax.vmap``.  The candidate
grid alpha_j = 0.5**j is scored by ONE closed-loop rollout over ``[B, na]``
lanes (the JAX ``vmap`` over alphas), the first accepted candidate of each
lane wins, and one re-roll at each lane's winning alpha recovers its
trajectory and constraint values.  The per-instance line search has no
Pallas kernel in the JAX package: these are the loops of
``ops/rollout.py``.
"""

from __future__ import annotations

import math

import torch

from ..core.spec import ProblemSpec
from . import al as al_ops
from . import linalg_small
from .batching import select
from .derivatives import device_constant
from .rollout import closed_loop_rollout, rollout_with_al_cost


def trajectory_sensitivities(fx, fu, K, k):
    """Closed-loop linearized trajectory delta for the Armijo slope:
    zx_0 = 0; zu_t = k_t + K_t zx_t; zx_{t+1} = fx_t zx_t + fu_t zu_t.
    Returns (zx [..., T-1, nx], zu [..., T-1, nu]) for stacks with any
    leading lane axes."""
    mv = linalg_small.matvec
    zx = fx.new_zeros(fx.shape[:-3] + fx.shape[-1:])
    zxs, zus = [], []
    for t in range(fx.shape[-3]):
        zu = k[..., t, :] + mv(K[..., t, :, :], zx)
        zxs.append(zx)
        zus.append(zu)
        zx = mv(fx[..., t, :, :], zx) + mv(fu[..., t, :, :], zu)
    return torch.stack(zxs, dim=-2), torch.stack(zus, dim=-2)


def armijo_slope(Qx, Qu, p, zx, zu):
    """gradient' * delta_z per lane, with the Lagrangian gradient
    Lx_t = Qx_t - p_t, Lu_t = Qu_t."""
    return (torch.sum((Qx - p) * zx, dim=(-2, -1))
            + torch.sum(Qu * zu, dim=(-2, -1)))


def step_sizes(n: int, dtype, device) -> torch.Tensor:
    """alpha_j = 0.5**j for j < n (exact powers of two)."""
    return device_constant([math.ldexp(1.0, -j) for j in range(n)], device, dtype)


def line_search(spec: ProblemSpec, objective_fn, xbar, ubar, ws, K, k, slope,
                J_prev, c_prev, options, duals, penalty):
    """Parallel-alpha Armijo search, per lane.

    ``objective_fn(xs, us) -> (J [B], c [B, T, nc])``.  Returns (xs, us, J,
    c, status, step_size): each lane's accepted candidate promoted to
    nominal, or its unchanged nominal with status False on failure.  The
    accepted objective is the scoring rollout's value, the number the Armijo
    test validated."""
    B = xbar.shape[0]
    if options.line_search == "none":
        # unconditional full step; only rollout divergence rejects
        xs, us = closed_loop_rollout(spec, xbar, ubar, ws, K, k, 1.0)
        J, c = objective_fn(xs, us)
        ok = torch.isfinite(J)
        return (select(ok, xs, xbar), select(ok, us, ubar),
                torch.where(ok, J, J_prev), select(ok, c, c_prev), ok,
                xbar.new_ones(B))

    na = options.num_step_sizes
    alphas = step_sizes(na, xbar.dtype, xbar.device)
    viol_filter = options.constraint_aware_acceptance and spec.nc > 0

    # every candidate in one rollout over [B, na] lanes (cost only)
    lane = lambda a: a[:, None]
    out = rollout_with_al_cost(
        spec, lane(xbar), lane(ubar), lane(ws), lane(K), lane(k), alphas,
        lane(duals), lane(penalty), cost_only=True, with_viol=viol_filter,
    )
    J_c = out[2]                                            # [B, na]

    c1 = torch.tensor(options.armijo_c1, dtype=xbar.dtype)
    accept = ((J_c <= J_prev[:, None] + (c1 * alphas)[None] * slope[:, None])
              & torch.isfinite(J_c))
    status = torch.any(accept, dim=-1)
    idx = torch.argmax(accept.to(torch.uint8), dim=-1)     # first accepted
    if viol_filter:
        # constraint-aware acceptance: among the accepted candidates prefer
        # the largest step that does not worsen the max violation (beyond
        # the tolerance); else the plain Armijo winner
        ineq = device_constant(spec.ineq_mask, xbar.device)
        cmask = device_constant(spec.c_mask, xbar.device)
        viol_prev = al_ops.max_violation(c_prev, ineq, cmask)
        gate = torch.clamp(viol_prev, min=options.constraint_tolerance)
        preferred = accept & (out[4] <= gate[:, None])
        idx = torch.where(torch.any(preferred, dim=-1),
                          torch.argmax(preferred.to(torch.uint8), dim=-1), idx)

    # re-roll each lane's winner: trajectory and constraint values
    alpha_w = alphas[idx]
    xs_w, us_w, _J_w, c_win = rollout_with_al_cost(
        spec, xbar, ubar, ws, K, k, alpha_w, duals, penalty)
    J_win = torch.gather(J_c, -1, idx[:, None])[:, 0]
    xs = select(status, xs_w, xbar)
    us = select(status, us_w, ubar)
    J = torch.where(status, J_win, J_prev)
    c = select(status, c_win, c_prev)
    # on failure the reference's loop exits having halved past min_step_size
    step_size = torch.where(status, alpha_w, alphas[-1] * 0.5)
    return xs, us, J, c, status, step_size
