"""Batch-last layout ops of the SL solver: line search, AL machinery,
objective evaluation.

Counterpart of ``iterativelqr_tpu/ops/sl_ops.py``.  There every array is
``[T, *dims, S, 128]`` to fill the TPU's (8, 128) tiles; on the card the
batch rides one trailing axis, ``[T, *dims, B]``, contiguous, so a batch of
lanes is a run of neighbouring addresses for every elementwise op.
``to_sl``/``from_sl`` convert between the public batch-leading layout and
this one.  Per-instance semantics are those of the JAX module; its
citations of the reference live there.

The rollouts of the line search are Python loops over t of small batched
ops (the JAX package's scans).  The JAX package's Pallas rollout kernels
(``forward_kernel="pallas"``) are not ported yet (ROADMAP K3/K4).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from ..core.spec import ProblemSpec
from .packed_pipeline import _grouped_bt2, map2


def map3(fn):
    """map2 plus a leading line-search-candidate axis on (x, u); w is shared
    across candidates."""
    return vmap(map2(fn), in_dims=(0, 0, None), out_dims=0)


def to_sl(a):
    """[B, leading...] -> contiguous [leading..., B]."""
    return a.movedim(0, -1).contiguous()


def from_sl(a):
    """[leading..., B] -> contiguous [B, leading...]."""
    return a.movedim(-1, 0).contiguous()


class SLOps:
    """Per-spec batch-last operations, built once per solver."""

    def __init__(self, spec: ProblemSpec, options, device=None,
                 dtype=torch.float32):
        self.spec = spec
        self.options = options
        T, nc = spec.T, spec.nc
        Tm1 = T - 1
        if options.forward_kernel == "pallas" and options.line_search == "armijo":
            raise NotImplementedError(
                "forward_kernel='pallas' is not ported yet (ROADMAP K3/K4)"
            )
        # "auto" resolves to the rollout loops: no rollout kernel is ported
        self._viol_filter = options.constraint_aware_acceptance and nc > 0
        self.ineq_t = torch.as_tensor(spec.ineq_mask, device=device)   # [T,nc]
        self.cmask_t = torch.as_tensor(spec.c_mask, device=device)     # [T,nc]
        self.ineq_sl = self.ineq_t[:, :, None]
        self.cmask_sl = self.cmask_t[:, :, None]
        na = options.num_step_sizes
        self.alphas = 0.5 ** torch.arange(na, dtype=dtype, device=device)

        self.dyn2 = [map2(f) for f in spec.dyn_eval]
        self.cost2 = [map2(f) for f in spec.cost_eval]
        self.con2 = [map2(f) for f in spec.con_eval]
        self.dyn3 = [map3(f) for f in spec.dyn_eval]
        self.cost3 = [map3(f) for f in spec.cost_eval]
        self.con3 = [map3(f) for f in spec.con_eval]

        # static per-step stage types: the rollout loops pick each step's
        # function in Python (the JAX scans switch on a traced index)
        self.td = [int(i) for i in spec.dyn_tidx]
        self.tg = [int(i) for i in spec.cost_tidx[:Tm1]]
        self.tc = [int(i) for i in spec.con_tidx[:Tm1]]
        self.gT = int(spec.cost_tidx[-1])
        self.cT = int(spec.con_tidx[-1])

        # grouped parallel (over t) cost+constraint evaluation for the entry
        # objective and the fresh exit constraints
        n_con = len(spec.con_eval)
        self.comb_gc = (
            spec.cost_tidx[:Tm1].astype(np.int64) * n_con + spec.con_tidx[:Tm1]
        )
        fns = {}
        for key in np.unique(self.comb_gc):
            gi, ci = divmod(int(key), n_con)
            g, cf = spec.cost_eval[gi], spec.con_eval[ci]

            def per_t(x, u, w, g=g, cf=cf):
                if nc > 0:
                    return g(x, u, w), cf(x, u, w)
                return (g(x, u, w),)

            fns[int(key)] = per_t
        self.eval_fns = fns

    # --- AL scalar machinery -----------------------------------------------

    def al_terms(self, c, duals, penalty):
        """Full-trajectory AL term: [T,nc,B] inputs -> [B]."""
        if self.spec.nc == 0:
            return c.new_zeros(c.shape[-1:])
        inactive = self.ineq_sl & (c < 0.0) & (duals == 0.0)
        a = (~inactive).to(c.dtype)
        return torch.sum(duals * c + 0.5 * a * penalty * c * c, dim=(0, 1))

    def max_violation(self, c):
        """[T,nc,B] -> [B] inf-norm violation."""
        if self.spec.nc == 0:
            return c.new_zeros(c.shape[-1:])
        v = torch.where(self.ineq_sl, torch.clamp(c, min=0.0), torch.abs(c))
        v = torch.where(self.cmask_sl, v, torch.zeros_like(v))
        return v.amax(dim=(0, 1))

    def al_transition(self, c, viol, duals, penalty, viol_prev,
                      truncated=False):
        """Stall-gated dual/penalty update, with the truncated-round rule
        (truncated rounds grow the penalty but never ascend, and never count
        as stalled); returns the post-update pair, the caller gates
        application."""
        o = self.options
        if self.spec.nc == 0:
            return duals, penalty
        truncated = torch.as_tensor(truncated, device=viol.device)
        if o.adaptive_penalty:
            stalled = (viol > o.penalty_stall_gate * viol_prev) & ~truncated
            scale_eff = torch.where(
                stalled,
                torch.full_like(viol, o.scaling_penalty * o.scaling_penalty_stalled),
                torch.full_like(viol, o.scaling_penalty),
            )
        else:
            stalled = torch.zeros(viol.shape, dtype=torch.bool, device=viol.device)
            scale_eff = torch.full_like(viol, o.scaling_penalty)
        new_duals = duals + penalty * c
        new_duals = torch.where(
            self.ineq_sl, torch.clamp(new_duals, min=0.0), new_duals
        )
        new_penalty = torch.clamp(scale_eff[None, None] * penalty, max=o.max_penalty)
        if o.adaptive_penalty:
            new_duals = torch.where(stalled, duals, new_duals)
        new_duals = torch.where(truncated, duals, new_duals)
        return new_duals, new_penalty

    # --- objective / constraint evaluation ---------------------------------

    def al_objective(self, xs, us, ws, duals, penalty):
        """Parallel-over-t evaluation: [T,nx,B] etc -> (J [B], c [T,nc,B])."""
        spec = self.spec
        nc = spec.nc
        T = spec.T
        B = xs.shape[-1]
        outs = _grouped_bt2(
            self.eval_fns, self.comb_gc, T - 1, (xs[:-1], us, ws[:-1])
        )
        if nc > 0:
            g, c_head = outs
        else:
            (g,) = outs
        u0 = xs.new_zeros((spec.nu, B))
        gT = self.cost2[self.gT](xs[-1], u0, ws[-1])
        J = torch.sum(g, dim=0) + gT
        if nc > 0:
            cT = self.con2[self.cT](xs[-1], u0, ws[-1])
            c = torch.cat([c_head, cT[None]], dim=0)
            J = J + self.al_terms(c, duals, penalty)
        else:
            c = xs.new_zeros((T, 0, B))
        return J, c

    # --- line search --------------------------------------------------------

    def _al_step_term(self, c_t, lam, rho, iq, dim):
        """lam*c + 1/2 a rho c^2 summed over the constraint axis ``dim``,
        with a = 0 on inactive inequality rows."""
        inactive = iq & (c_t < 0.0) & (lam == 0.0)
        a = (~inactive).to(c_t.dtype)
        return torch.sum(lam * c_t + 0.5 * a * rho * c_t * c_t, dim=dim)

    def line_search(self, xbar, ubar, ws, K, k, slope, J_prev, c_prev,
                    duals, penalty, need=None):
        """Parallel-alpha Armijo search, batch-last end to end.

        Every candidate alpha_j = 0.5**j is scored by a closed-loop rollout
        that accumulates the AL objective; the largest acceptable alpha per
        lane wins, and one winner re-roll (per-lane alpha) recovers the
        trajectory and constraint values.  Candidates split into a head block
        (8) scored always and a tail block scored only when some lane in
        ``need`` (None = all) has no head acceptance — one host sync.

        Returns (xs, us, J, c, status, step_size).
        """
        spec = self.spec
        o = self.options
        nc = spec.nc
        dtype = xbar.dtype
        B = xbar.shape[-1]
        nu, nx = spec.nu, spec.nx
        Tm1 = spec.T - 1
        ineq_t = self.ineq_t

        def roll(alpha):
            """One closed-loop rollout at per-lane step size ``alpha`` [B],
            emitting trajectory, objective and constraints."""
            x = xbar[0]
            J = xbar.new_zeros(B)
            xs_l, us_l, cs_l = [], [], []
            for t in range(Tm1):
                dx = x - xbar[t]
                u = ubar[t] + torch.sum(K[t] * dx[None], dim=1) + alpha[None] * k[t]
                w = ws[t]
                J = J + self.cost2[self.tg[t]](x, u, w)
                if nc > 0:
                    c_t = self.con2[self.tc[t]](x, u, w)
                    J = J + self._al_step_term(
                        c_t, duals[t], penalty[t], ineq_t[t][:, None], 0
                    )
                    cs_l.append(c_t)
                xs_l.append(x)
                us_l.append(u)
                x = self.dyn2[self.td[t]](x, u, w)
            u0 = xbar.new_zeros((nu, B))
            J = J + self.cost2[self.gT](x, u0, ws[-1])
            if nc > 0:
                cT = self.con2[self.cT](x, u0, ws[-1])
                J = J + self._al_step_term(
                    cT, duals[-1], penalty[-1], ineq_t[-1][:, None], 0
                )
                c = torch.stack(cs_l + [cT])
            else:
                c = xbar.new_zeros((spec.T, 0, B))
            xs = torch.stack(xs_l + [x])
            us = torch.stack(us_l)
            return xs, us, J, c

        if o.line_search == "none":
            # unconditional full step (reference: src/options.jl:2)
            ones = xbar.new_ones(B)
            xs_w, us_w, J_w, c_w = roll(ones)
            ok = torch.isfinite(J_w)
            return (
                torch.where(ok, xs_w, xbar),
                torch.where(ok, us_w, ubar),
                torch.where(ok, J_w, J_prev),
                torch.where(ok, c_w, c_prev),
                ok,
                ones,
            )

        na = o.num_step_sizes
        alphas = self.alphas.to(dtype)
        c1 = torch.tensor(o.armijo_c1, dtype=dtype, device=xbar.device)
        viol_filter = self._viol_filter

        def score_block(alphas_blk):
            """Score a block of candidates in one rollout loop, the candidate
            axis leading; with the violation filter also the per-candidate
            max violation."""
            nb = alphas_blk.shape[0]
            x = xbar[0][None].expand(nb, nx, B)
            J = xbar.new_zeros((nb, B))
            V = xbar.new_zeros((nb, B)) if viol_filter else None
            for t in range(Tm1):
                dx = x - xbar[t][None]
                u = (
                    ubar[t][None]
                    + torch.sum(K[t][None] * dx[:, None], dim=2)
                    + alphas_blk[:, None, None] * k[t][None]
                )
                w = ws[t]
                J = J + self.cost3[self.tg[t]](x, u, w)
                if nc > 0:
                    c_t = self.con3[self.tc[t]](x, u, w)   # [nb,nc,B]
                    iq = ineq_t[t][None, :, None]
                    J = J + self._al_step_term(
                        c_t, duals[t][None], penalty[t][None], iq, 1
                    )
                    if viol_filter:
                        v = torch.where(iq, torch.clamp(c_t, min=0.0), torch.abs(c_t))
                        v = torch.where(self.cmask_t[t][None, :, None], v,
                                        torch.zeros_like(v))
                        V = torch.maximum(V, v.amax(dim=1))
                x = self.dyn3[self.td[t]](x, u, w)
            u0 = xbar.new_zeros((nb, nu, B))
            J = J + self.cost3[self.gT](x, u0, ws[-1])
            if nc > 0:
                cT = self.con3[self.cT](x, u0, ws[-1])
                iq = ineq_t[-1][None, :, None]
                J = J + self._al_step_term(
                    cT, duals[-1][None], penalty[-1][None], iq, 1
                )
                if viol_filter:
                    v = torch.where(iq, torch.clamp(cT, min=0.0), torch.abs(cT))
                    v = torch.where(self.cmask_t[-1][None, :, None], v,
                                    torch.zeros_like(v))
                    V = torch.maximum(V, v.amax(dim=1))
            return J, V

        def acc(J_blk, alphas_blk):
            return (
                J_blk <= J_prev[None] + c1 * alphas_blk[:, None] * slope[None]
            ) & torch.isfinite(J_blk)

        n1 = min(8, na)
        if viol_filter:
            # constraint-aware acceptance: among the accepted candidates
            # prefer the largest step whose max violation does not worsen
            # beyond max(previous violation, tolerance)
            viol_gate = torch.clamp(
                self.max_violation(c_prev), min=o.constraint_tolerance
            )
        J_head, V_head = score_block(alphas[:n1])
        J_c, V_c = J_head, V_head
        if na > n1:
            # the tail can only change lanes with no head acceptance (the
            # winner is the largest accepted alpha)
            head_acc = acc(J_head, alphas[:n1])
            if viol_filter:
                head_ok = torch.any(head_acc & (V_head <= viol_gate[None]), dim=0)
            else:
                head_ok = torch.any(head_acc, dim=0)
            settled = head_ok if need is None else (head_ok | ~need)
            if bool(settled.all()):
                tail = xbar.new_full((na - n1, B), float("inf"))
                J_tail, V_tail = tail, (tail if viol_filter else None)
            else:
                J_tail, V_tail = score_block(alphas[n1:])
            J_c = torch.cat([J_head, J_tail], dim=0)
            if viol_filter:
                V_c = torch.cat([V_head, V_tail], dim=0)

        accept = acc(J_c, alphas)
        status = torch.any(accept, dim=0)                   # [B]
        idx = torch.argmax(accept.to(torch.uint8), dim=0)   # first accepted
        if viol_filter:
            preferred = accept & (V_c <= viol_gate[None])
            idx = torch.where(
                torch.any(preferred, dim=0),
                torch.argmax(preferred.to(torch.uint8), dim=0), idx,
            )
        alpha_win = alphas[idx]
        J_win = torch.gather(J_c, 0, idx[None])[0]

        xs_w, us_w, _J_reroll, c_w = roll(alpha_win)
        xs = torch.where(status, xs_w, xbar)
        us = torch.where(status, us_w, ubar)
        J = torch.where(status, J_win, J_prev)
        c = torch.where(status, c_w, c_prev)
        step_size = torch.where(status, alpha_win, alphas[-1] * 0.5)
        return xs, us, J, c, status, step_size
