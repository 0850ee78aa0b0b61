"""Horizon-stacked evaluation and differentiation of stage functions.

Counterpart of ``iterativelqr_tpu/ops/derivatives.py``.  Each stage type is
evaluated over its statically known timesteps and the rows are put back in
time order.  Arguments are ``[..., T, dim]`` tensors: one instance, or a
batch with leading lane axes (the per-instance solver's batched form); the
timesteps of a group and the lanes are one flattened ``torch.func.vmap``
(``ops/batching.py::lane_eval``).  ``stage_derivatives`` is the fused
pass of the JAX module, one evaluation a combined (dynamics, cost) stage
type; as there, the solver does not call it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.spec import ProblemSpec
from .batching import lane_eval


@functools.lru_cache(maxsize=None)
def _constant(data: bytes, np_dtype: str, shape: tuple, device: torch.device,
              dtype):
    a = np.frombuffer(data, dtype=np_dtype).reshape(shape)
    return torch.as_tensor(a.copy(), device=device, dtype=dtype)


def device_constant(a, device, dtype=None):
    """A static numpy array (mask, index) as a tensor on ``device``, made
    once per (array, device, dtype): a host-to-device copy of pageable
    memory waits for the stream, so the solver's loops must not make one."""
    a = np.ascontiguousarray(a)
    return _constant(a.tobytes(), a.dtype.str, a.shape, torch.device(device),
                     dtype)


def _merge_groups(results, groups, dim=0):
    """Rows of per-group results (each a tensor or a tuple of tensors with
    the group's timesteps on axis ``dim``) back in time order.  ``groups``
    partition the rows.  A concatenation and one gather, so the merge also
    works under an outer ``vmap`` (an in-place scatter would not)."""
    inv = np.argsort(np.concatenate(groups))

    def merge(parts):
        cat = torch.cat(parts, dim=dim)
        return cat.index_select(dim, device_constant(inv, cat.device))

    if isinstance(results[0], tuple):
        return tuple(merge(parts) for parts in zip(*results))
    return merge(results)


def _grouped(fns, groups, args):
    """fns[g] over its timestep group (axis -2 of every argument), rows back
    in time order; leading lane axes are kept."""
    if len(fns) == 1:
        return lane_eval(fns[0], *args)
    results = []
    for fn, idx in zip(fns, groups):
        idx_t = device_constant(idx, args[0].device)
        results.append(lane_eval(fn, *(a.index_select(-2, idx_t) for a in args)))
    return _merge_groups(results, groups, dim=args[0].ndim - 2)


def _us_full(spec: ProblemSpec, us):
    """Actions padded with a terminal zero row: terminal stage functions see
    u = 0 (their true action dim is 0)."""
    return torch.cat([us, us.new_zeros(us.shape[:-2] + (1, spec.nu))], dim=-2)


def stage_costs(spec: ProblemSpec, xs, us, ws):
    """Per-timestep cost values [..., T]."""
    return _grouped(spec.cost_eval, spec.cost_groups, (xs, _us_full(spec, us), ws))


def total_cost(spec: ProblemSpec, xs, us, ws):
    return torch.sum(stage_costs(spec, xs, us, ws), dim=-1)


def cost_gradients(spec: ProblemSpec, xs, us, ws):
    """gx [..., T, nx], gu [..., T-1, nu]."""
    gx, gu = _grouped(spec.cost_grad, spec.cost_groups,
                      (xs, _us_full(spec, us), ws))
    return gx, gu[..., :-1, :]


def cost_hessians(spec: ProblemSpec, xs, us, ws):
    """gxx [..., T, nx, nx], guu [..., T-1, nu, nu], gux [..., T-1, nu, nx]."""
    gxx, guu, gux = _grouped(spec.cost_hess, spec.cost_groups,
                             (xs, _us_full(spec, us), ws))
    return gxx, guu[..., :-1, :, :], gux[..., :-1, :, :]


def dynamics_values(spec: ProblemSpec, xs, us, ws):
    """f_t(x_t, u_t, w_t) for all t, [..., T-1, nx]."""
    return _grouped(spec.dyn_eval, spec.dyn_groups,
                    (xs[..., :-1, :], us, ws[..., :-1, :]))


def dynamics_jacobians(spec: ProblemSpec, xs, us, ws):
    """fx [..., T-1, nx, nx], fu [..., T-1, nx, nu]."""
    return _grouped(spec.dyn_jac, spec.dyn_groups,
                    (xs[..., :-1, :], us, ws[..., :-1, :]))


def dynamics_hessians(spec: ProblemSpec, xs, us, ws):
    """Second derivatives of the dynamics, for full DDP (``Options.ddp``):
    fxx [..., T-1, nx, nx, nx], fuu [..., T-1, nx, nu, nu], fux
    [..., T-1, nx, nu, nx], with fxx[..., t, i, a, b] = d2 f_i / dx_a dx_b
    (``core/spec.py::hess_fn``).  They feed the DDP terms of
    ``ops/backward.py::riccati_step``."""
    return _grouped(spec.dyn_hess, spec.dyn_groups,
                    (xs[..., :-1, :], us, ws[..., :-1, :]))


def stage_derivatives(spec: ProblemSpec, xs, us, ws):
    """All cost and dynamics derivative stacks in one pass: each combined
    (dynamics, cost) stage type evaluates its Jacobians, gradients and
    Hessians in one vmapped function over its timesteps; the terminal
    cost is evaluated apart (u = 0).  The solver does not call it (the
    JAX package's note: the fused pass won alone and lost in the solve).

    Returns (fx [..., T-1, nx, nx], fu [..., T-1, nx, nu], gx [..., T, nx],
    gu [..., T-1, nu], gxx [..., T, nx, nx], guu [..., T-1, nu, nu], gux
    [..., T-1, nu, nx]), equal to the separate stacks."""
    Tm1 = spec.T - 1
    n_cost = len(spec.cost_eval)
    comb = np.asarray(spec.dyn_tidx) * n_cost + np.asarray(spec.cost_tidx[:Tm1])
    keys = np.unique(comb)

    def per_t(di, gi):
        dj, cg, ch = spec.dyn_jac[di], spec.cost_grad[gi], spec.cost_hess[gi]
        return lambda x, u, w: (*dj(x, u, w), *cg(x, u, w), *ch(x, u, w))

    fns = [per_t(*divmod(int(k), n_cost)) for k in keys]
    groups = [np.nonzero(comb == k)[0] for k in keys]
    fx, fu, gx, gu, gxx, guu, gux = _grouped(fns, groups, (xs[..., :-1, :], us,
                                                           ws[..., :-1, :]))
    gT = int(spec.cost_tidx[-1])
    last = (xs[..., -1:, :], us.new_zeros(us.shape[:-2] + (1, spec.nu)), ws[..., -1:, :])
    gxT, _ = lane_eval(spec.cost_grad[gT], *last)
    gxxT, _, _ = lane_eval(spec.cost_hess[gT], *last)
    return (fx, fu, torch.cat([gx, gxT], dim=-2), gu, torch.cat([gxx, gxxT], dim=-3), guu,
            gux)


def constraint_values(spec: ProblemSpec, xs, us, ws):
    """c [..., T, nc]; padded rows are exactly zero."""
    if spec.nc == 0:
        return xs.new_zeros(xs.shape[:-1] + (0,))
    return _grouped(spec.con_eval, spec.con_groups, (xs, _us_full(spec, us), ws))


def constraint_jacobians(spec: ProblemSpec, xs, us, ws):
    """cx [..., T, nc, nx], cu [..., T-1, nc, nu]; the terminal constraint
    has no action Jacobian."""
    lead = xs.shape[:-2]
    if spec.nc == 0:
        return (xs.new_zeros(lead + (spec.T, 0, spec.nx)),
                xs.new_zeros(lead + (spec.T - 1, 0, spec.nu)))
    cx, cu = _grouped(spec.con_jac, spec.con_groups, (xs, _us_full(spec, us), ws))
    return cx, cu[..., :-1, :, :]
