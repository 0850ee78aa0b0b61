"""Augmented-Lagrangian constraint handling, per instance.

Counterpart of ``iterativelqr_tpu/ops/al.py`` (its citations of the
reference live there).  Quantities are padded ``[..., T, nc]`` tensors with
any leading lane axes; a per-instance scalar is a ``[...]`` tensor.  The SL
solver's batch-last versions of these are ``ops/sl_ops.py``.
"""

from __future__ import annotations

import torch


def active_set(c, duals, ineq_mask):
    """1.0 where the constraint enters the penalty, 0.0 otherwise: an
    inequality row is inactive iff c < 0 and lambda == 0 (exactly)."""
    inactive = ineq_mask & (c < 0.0) & (duals == 0.0)
    return (~inactive).to(c.dtype)


def al_terms(c, duals, penalty, ineq_mask):
    """lambda'c + 1/2 sum_active rho_i c_i^2 -> [...]."""
    a = active_set(c, duals, ineq_mask)
    return (torch.sum(duals * c, dim=(-2, -1))
            + 0.5 * torch.sum(a * penalty * c * c, dim=(-2, -1)))


def max_violation(c, ineq_mask, c_mask):
    """Inf-norm violation -> [...]: max(0, c) for inequality rows, |c| for
    equality rows, padded rows excluded."""
    if c.shape[-1] * c.shape[-2] == 0:
        return c.new_zeros(c.shape[:-2])
    v = torch.where(ineq_mask, torch.clamp(c, min=0.0), torch.abs(c))
    v = torch.where(c_mask, v, torch.zeros_like(v))
    return v.amax(dim=(-2, -1))


def dual_update(c, duals, penalty, ineq_mask, scaling_penalty, max_penalty):
    """Dual ascent + geometric penalty schedule: lambda += rho*c, lambda >= 0
    on inequality rows, rho <- min(scale*rho, rho_max).  ``scaling_penalty``
    is a number or a per-lane tensor [...]."""
    new_duals = duals + penalty * c
    new_duals = torch.where(ineq_mask, torch.clamp(new_duals, min=0.0), new_duals)
    if torch.is_tensor(scaling_penalty):
        scaling_penalty = scaling_penalty[..., None, None]
    new_penalty = torch.clamp(scaling_penalty * penalty, max=max_penalty)
    return new_duals, new_penalty


def al_gradient_terms(c, cx, cu, duals, penalty, ineq_mask):
    """Gauss-Newton AL contributions to the cost derivatives:

        gx  += cx' (lambda + Irho c)        gxx += cx' Irho cx
        gu  += cu' (lambda + Irho c)        guu += cu' Irho cu
                                            gux += cu' Irho cx

    with Irho = diag(rho * active); c [..., T, nc], cx [..., T, nc, nx],
    cu [..., T-1, nc, nu].  Broadcast-multiply-reduce (as the SL pipeline
    writes the same sums)."""
    a = active_set(c, duals, ineq_mask)
    irho = penalty * a                       # [..., T, nc]
    ctmp = duals + irho * c
    cxr = cx * irho[..., None]
    cur = cu * irho[..., :-1, :, None]
    dgx = torch.sum(cx * ctmp[..., None], dim=-2)
    dgxx = torch.sum(cxr[..., :, :, None] * cx[..., :, None, :], dim=-3)
    dgu = torch.sum(cu * ctmp[..., :-1, :, None], dim=-2)
    dguu = torch.sum(cur[..., :, :, None] * cu[..., :, None, :], dim=-3)
    dgux = torch.sum(cur[..., :, :, None] * cx[..., :-1, :, None, :], dim=-3)
    return dgx, dgu, dgxx, dguu, dgux
