"""Batch-last layout ops of the SL solver: line search, AL machinery,
objective evaluation.

Counterpart of ``iterativelqr_tpu/ops/sl_ops.py``.  There every array is
``[T, *dims, S, 128]`` to fill the TPU's (8, 128) tiles; on the card the
batch rides one trailing axis, ``[T, *dims, B]``, contiguous, so a batch of
lanes is a run of neighbouring addresses for every elementwise op.
``to_sl``/``from_sl`` convert between the public batch-leading layout and
this one.  Per-instance semantics are those of the JAX module; its
citations of the reference live there.

The rollouts of the line search live in ``ops/sl_forward_kernel.py``:
``forward_kernel="pallas"`` (the reference's option value) runs the CUDA
rollout kernels K3/K4 there, ``"scan"`` the plain loops, and ``"auto"`` the
kernels when the solver runs on the card and the spec has a device model
(a registered one, or one generated from its stage functions).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import ProblemSpec
from ..utils import profiling
from . import sl_forward_kernel as fk
from .packed_pipeline import _grouped_bt2


def to_sl(a):
    """[B, leading...] -> contiguous [leading..., B]."""
    return a.movedim(0, -1).contiguous()


def from_sl(a):
    """[leading..., B] -> contiguous [B, leading...]."""
    return a.movedim(-1, 0).contiguous()


class SLOps:
    """Per-spec batch-last operations, built once per solver for one
    ``device``."""

    def __init__(self, spec: ProblemSpec, options, device,
                 dtype=torch.float32):
        self.spec = spec
        self.options = options
        T, nc = spec.T, spec.nc
        Tm1 = T - 1
        device = torch.device(device)
        self.rollouts = fk.Rollouts(spec, device)
        self._viol_filter = options.constraint_aware_acceptance and nc > 0
        self.use_kernels = fk.select_kernels(spec, options, device)
        if self.use_kernels:
            self.rollouts.prepare()   # a generated model is compiled now
        self.ineq_sl = self.rollouts.ineq_t[:, :, None]
        self.cmask_sl = self.rollouts.cmask_t[:, :, None]
        self.alphas = self.rollouts.alphas(dtype, options.num_step_sizes)

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
        r = self.rollouts
        gT = r.cost2[r.gT](xs[-1], u0, ws[-1])
        J = torch.sum(g, dim=0) + gT
        if nc > 0:
            cT = r.con2[r.cT](xs[-1], u0, ws[-1])
            c = torch.cat([c_head, cT[None]], dim=0)
            J = J + self.al_terms(c, duals, penalty)
        else:
            c = xs.new_zeros((T, 0, B))
        return J, c

    # --- line search --------------------------------------------------------

    def line_search(self, xbar, ubar, ws, K, k, slope, J_prev, c_prev,
                    duals, penalty, need=None):
        """Parallel-alpha Armijo search, batch-last end to end.

        Every candidate alpha_j = 0.5**j is scored by a closed-loop rollout
        that accumulates the AL objective; the largest acceptable alpha per
        lane wins, and one winner re-roll (per-lane alpha) recovers the
        trajectory and constraint values.  Candidates split into a head block
        (8) scored always and a tail block scored only when some lane in
        ``need`` (None = all) has no head acceptance — one host sync.  With
        ``use_kernels`` each block is one K3 launch and the re-roll one K4
        launch; otherwise both are the plain loops.

        Returns (xs, us, J, c, status, step_size).
        """
        o = self.options
        r = self.rollouts
        dtype = xbar.dtype
        B = xbar.shape[-1]
        live = (xbar, ubar, ws, K, k, duals, penalty)

        if o.line_search == "none":
            # unconditional full step (reference: src/options.jl:2)
            ones = xbar.new_ones(B)
            xs_w, us_w, J_w, c_w = fk.winner_reroll_reference(r, ones, *live)
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

        if self.use_kernels:
            def score_block(j0, nb):
                return fk.score_rollout(r, j0, nb, *live), None

            roll_winner = lambda a: fk.winner_reroll(r, a, *live)
        else:
            def score_block(j0, nb):
                out = fk.score_rollout_reference(r, j0, nb, *live,
                                                 violation=viol_filter)
                return out if viol_filter else (out, None)

            roll_winner = lambda a: fk.winner_reroll_reference(r, a, *live)

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
        J_head, V_head = score_block(0, n1)
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
            with profiling.sync("sync.tail"):
                all_settled = bool(settled.all())
            if all_settled:
                tail = xbar.new_full((na - n1, B), float("inf"))
                J_tail, V_tail = tail, (tail if viol_filter else None)
            else:
                J_tail, V_tail = score_block(n1, na - n1)
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

        xs_w, us_w, _J_reroll, c_w = roll_winner(alpha_win)
        xs = torch.where(status, xs_w, xbar)
        us = torch.where(status, us_w, ubar)
        J = torch.where(status, J_win, J_prev)
        c = torch.where(status, c_w, c_prev)
        step_size = torch.where(status, alpha_win, alphas[-1] * 0.5)
        return xs, us, J, c, status, step_size
