"""Derive -> AL augmentation -> backward -> Armijo slope, batch-last.

Counterpart of ``iterativelqr_tpu/ops/packed_pipeline.py``: its
``_build(...).batched_sl`` path (``make_derive_backward_sl``, the SL
solver's step) and the ``custom_vmap`` dispatch of ``backward_pass="packed"``
on the per-instance solver's vmap route (``make_derive_backward``).  The
derivative stacks are born in the backward kernel's batch-last layout
``[T, *dims, B]`` by vmapping the per-timestep derivative functions over t
and over the trailing batch axis, so no stack is ever re-laid-out before the
kernel (``ops/packed_backward.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.func import vmap

from ..core.spec import ProblemSpec
from ..utils import profiling
from . import packed_backward as pk
from .batching import custom_vmap
from .derivatives import _merge_groups


def map2(fn):
    """vmap a per-(x,u,w) function over the trailing batch axis (the JAX
    package's ``map2`` maps its two trailing tile axes)."""
    return vmap(fn, in_dims=-1, out_dims=-1)


def _bt2_tmap(fn):
    """vmap a per-(x,u,w) function over [t, :, B] arrays (t on axis 0,
    batch on the last axis)."""
    return vmap(map2(fn), in_dims=0, out_dims=0)


def _grouped_bt2(fns, comb_key, rows, args):
    """Evaluate ``fns[key]`` over the timesteps of each combined stage-type
    key; args are [rows, :, B] arrays.  Type indices are static numpy, so
    the grouping is a Python loop over ``np.unique`` (no traced switch)."""
    uniq = np.unique(comb_key)
    if len(uniq) == 1:
        return _bt2_tmap(fns[int(uniq[0])])(*args)
    results, groups = [], []
    for key in uniq:
        idx = np.nonzero(comb_key == key)[0]
        idx_t = torch.as_tensor(idx, device=args[0].device)
        results.append(_bt2_tmap(fns[int(key)])(*(a[idx_t] for a in args)))
        groups.append(idx)
    return _merge_groups(results, groups)


def make_derive_backward_sl(spec: ProblemSpec, options, device):
    """Build the batch-last derive+backward+slope step of the SL solver:

        (xs [T,nx,B], us [T-1,nu,B], ws [T,npar,B], duals [T,nc,B],
         penalty [T,nc,B], c [T,nc,B], reg [B], valid=None)
          -> (K [T-1,nu,nx,B], k [T-1,nu,B], slope [B], grad_norm [B],
              reg_next [B])

    ``valid`` (bool [B] or None) marks real lanes: lanes outside it never
    hold the regularization retry open.  ``device`` (the solve's device,
    from the caller) places the static masks.  On the card the solvers
    build the recursion's kernels for (nx, nu, dtype) when a solve starts
    (``core/solve_sl.py::build_kernels``, ``core/solve.py``).
    """
    T, nx, nu, nc = spec.T, spec.nx, spec.nu, spec.nc
    Tm1 = T - 1
    o = options
    ineq = torch.as_tensor(spec.ineq_mask, device=device)[:, :, None]
    u_mask = torch.as_tensor(spec.u_mask, device=device)
    x_m = torch.as_tensor(spec.x_mask[:-1], device=device)[:, :, None]
    u_m = u_mask[:, :, None]

    # combined per-timestep derivative function per (dyn, cost, con) type key
    n_cost = len(spec.cost_eval)
    n_con = len(spec.con_eval)
    comb_key = (
        spec.dyn_tidx.astype(np.int64) * n_cost + spec.cost_tidx[:Tm1]
    ) * n_con + spec.con_tidx[:Tm1]
    fns = {}
    for key in np.unique(comb_key):
        di, rest = divmod(int(key), n_cost * n_con)
        gi, ci = divmod(rest, n_con)
        dj, cg, ch, cj = (
            spec.dyn_jac[di], spec.cost_grad[gi], spec.cost_hess[gi],
            spec.con_jac[ci],
        )

        def per_t(x, u, w, dj=dj, cg=cg, ch=ch, cj=cj):
            fx, fu = dj(x, u, w)
            gx, gu = cg(x, u, w)
            gxx, guu, gux = ch(x, u, w)
            if nc > 0:
                cx, cu = cj(x, u, w)
                return fx, fu, gx, gu, gxx, guu, gux, cx, cu
            return fx, fu, gx, gu, gxx, guu, gux

        fns[int(key)] = per_t

    gT = int(spec.cost_tidx[-1])
    cT = int(spec.con_tidx[-1])
    grad_T = map2(spec.cost_grad[gT])
    hess_T = map2(spec.cost_hess[gT])
    cjac_T = map2(spec.con_jac[cT])

    def derive(xs, us, ws, lam, rho, c, reg, valid=None):
        dtype = xs.dtype
        B = xs.shape[-1]
        with profiling.annotate("derive"):
            stacks = _grouped_bt2(fns, comb_key, Tm1, (xs[:-1], us, ws[:-1]))
            if nc > 0:
                fx, fu, gx_s, gu, gxx_s, guu, gux, cx_s, cu = stacks
            else:
                fx, fu, gx_s, gu, gxx_s, guu, gux = stacks

            # terminal stage (u = 0)
            u0 = xs.new_zeros((nu, B))
            gxT, _ = grad_T(xs[-1], u0, ws[-1])
            gxxT, _, _ = hess_T(xs[-1], u0, ws[-1])
            gx = torch.cat([gx_s, gxT[None]], dim=0)       # [T,nx,B]
            gxx = torch.cat([gxx_s, gxxT[None]], dim=0)    # [T,nx,nx,B]
            if nc > 0:
                cxT, _ = cjac_T(xs[-1], u0, ws[-1])
                cx = torch.cat([cx_s, cxT[None]], dim=0)   # [T,nc,nx,B]

        with profiling.annotate("augment"):
            # AL Gauss-Newton augmentation (broadcast-multiply-reduce, as
            # the JAX pipeline writes it)
            if nc > 0:
                inactive = ineq & (c < 0.0) & (lam == 0.0)
                a = (~inactive).to(dtype)
                irho = rho * a
                ctmp = lam + irho * c
                cxr = cx * irho[:, :, None]                 # [t,c,i,B]
                cur = cu * irho[:-1, :, None]
                gx = gx + torch.sum(cx * ctmp[:, :, None], dim=1)
                gxx = gxx + torch.sum(cxr[:, :, :, None] * cx[:, :, None, :], dim=1)
                gu = gu + torch.sum(cu * ctmp[:-1, :, None], dim=1)
                guu = guu + torch.sum(cur[:, :, :, None] * cu[:, :, None, :], dim=1)
                gux = gux + torch.sum(cur[:, :, :, None] * cx[:-1, :, None, :], dim=1)

            kin = pk.prepare_stacks(fx, fu, gx, gu, gxx, guu, gux, u_mask)
            kin = tuple(t.contiguous() for t in kin)
            stacks_k, gxxT_k, gxT_k = kin[:7], kin[7], kin[8]

        with profiling.annotate("backward"):
            # adaptive-regularization retry around the kernel, batch-wide as
            # in the JAX pipeline: lanes already ok re-run with their own
            # reg.  The loop test is one host sync per kernel launch.
            reg = reg.to(dtype)
            reg_try, reg_used = reg, reg
            ok = torch.zeros(B, dtype=torch.bool, device=xs.device)
            outs = None
            i = 0
            while i <= o.max_regularization_steps:
                with profiling.sync("sync.retry"):
                    if bool(ok.all()):
                        break
                reg_run = torch.where(ok, reg_used, reg_try).contiguous()
                outs = pk.backward_pass_multiref(stacks_k, gxxT_k, gxT_k, reg_run)
                ok_now = outs[-1] > 0.5
                if valid is not None:
                    ok_now = ok_now | ~valid
                reg_next = torch.clamp(reg_run * o.regularization_scale,
                                       o.regularization_min, o.regularization_max)
                reg_try = torch.where(ok_now, reg_run, reg_next)
                reg_used = reg_run
                ok = ok_now
                i += 1
            if outs is None:
                # max_regularization_steps < 0: no attempt, zero gains and
                # ok false, as the JAX loop's initial state
                outs = tuple(a.zero_() for a in pk.new_outputs(Tm1, nx, nu, B, dtype, xs.device))
            K_t, k_t, Qx_t, Qu_t, p_t, _ok = outs

        with profiling.annotate("slope"):
            # Lagrangian gradient norm
            lx = torch.abs(Qx_t - p_t) * x_m.to(dtype)
            lu = torch.abs(Qu_t) * u_m.to(dtype)
            grad_norm = torch.maximum(
                lx.amax(dim=(0, 1)), lu.amax(dim=(0, 1))
            )                                               # [B]

            # Armijo slope via the closed-loop sensitivity recursion
            zx = xs.new_zeros((nx, B))
            zxs, zus = [], []
            for t in range(Tm1):
                zu = k_t[t] + torch.sum(K_t[t] * zx[None], dim=1)
                zxs.append(zx)
                zus.append(zu)
                zx = (
                    torch.sum(fx[t] * zx[None], dim=1)
                    + torch.sum(fu[t] * zu[None], dim=1)
                )
            zx_s = torch.stack(zxs)
            zu_s = torch.stack(zus)
            slope = torch.sum((Qx_t - p_t) * zx_s, dim=(0, 1)) + torch.sum(
                Qu_t * zu_s, dim=(0, 1)
            )

            # reg decay for the next iteration
            reg_next_carry = torch.where(
                reg_used <= o.regularization_min,
                torch.zeros_like(reg_used),
                reg_used / o.regularization_scale,
            )
        return K_t, k_t, slope, grad_norm, reg_next_carry

    return derive


def make_derive_backward(spec: ProblemSpec, options, single, *, device):
    """The ``custom_vmap`` derive+backward+slope of ``backward_pass="packed"``
    on the per-instance solver's vmap route (``core/solve.py``).

    Per-instance signature (``single``, the solver's scan path, which is
    what the JAX dispatch's unbatched call computes):
        (xs [T,nx], us [T-1,nu], ws [T,npar], duals [T,nc], penalty [T,nc],
         c [T,nc], reg scalar)
          -> (K [T-1,nu,nx], k [T-1,nu], slope, grad_norm, reg_next)

    The batched rule converts the batch-leading arguments to the batch-last
    layout and runs ``make_derive_backward_sl``: K1/K2 on the card, their
    plain version on the CPU.  (The JAX rule falls back to vmapping the
    per-instance path off the TPU; the card takes the TPU's place here, as
    ``ops/sl_forward_kernel.py::select_kernels`` treats it.)
    """
    @functools.lru_cache(maxsize=None)
    def built():
        return make_derive_backward_sl(spec, options, device)

    dispatch = custom_vmap(single)

    @dispatch.def_vmap
    def _rule(axis_size, in_batched, xs, us, ws, duals, penalty, c, reg):
        if not all(in_batched[:2]):
            raise NotImplementedError("xs/us must be batched on axis 0")
        args = [a if b else a[None].expand((axis_size,) + tuple(a.shape))
                for a, b in zip((xs, us, ws, duals, penalty, c, reg), in_batched)]
        last = [a.movedim(0, -1).contiguous() for a in args[:6]]
        K_t, k_t, slope, grad_norm, reg_next = built()(
            *last, args[6].to(xs.dtype).contiguous())
        return (K_t.movedim(-1, 0), k_t.movedim(-1, 0), slope, grad_norm,
                reg_next)

    return dispatch
