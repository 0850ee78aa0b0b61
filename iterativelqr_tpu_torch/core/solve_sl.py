"""SL batched solver: the fused AL x iLQR loop, batch-last.

Counterpart of ``iterativelqr_tpu/core/solve_sl.py``.  The whole batched
solve runs on ``[T, *dims, B]`` tensors (``ops/sl_ops.py``); layouts convert
once at entry and once at exit.  Per-instance semantics are those of the
JAX module (same iterate sequence, stopping rules, dual-update points).

The JAX ``lax.while_loop`` is a Python loop here: its test ``all(stop)`` is
one host sync per iteration.  Each trip is a span (``utils/profiling.py``)
whose children partition it: ``derive``, ``augment``, ``backward`` and
``slope`` (``ops/packed_pipeline.py``), ``line_search`` and ``al_update``.

Restrictions (as in the JAX module): no record_traces, no live_progress,
fused AL loop only, no ddp.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, NamedTuple

import torch

from ..ops import derive_kernel as dk
from ..ops import packed_backward as pk
from ..ops.packed_pipeline import make_derive_backward_sl
from ..ops.sl_forward_kernel import device_model, select_kernels
from ..ops.sl_ops import SLOps, from_sl, to_sl
from ..utils import profiling
from .options import Options
from .solve import Solution
from .spec import ProblemSpec


class _SLCarry(NamedTuple):
    xs: torch.Tensor        # [T, nx, B]
    us: torch.Tensor        # [T-1, nu, B]
    duals: torch.Tensor     # [T, nc, B]
    penalty: torch.Tensor   # [T, nc, B]
    J: torch.Tensor         # [B]
    c: torch.Tensor         # [T, nc, B]
    reg: torch.Tensor       # [B]
    viol_prev: torch.Tensor
    al_it: torch.Tensor     # [B] int32
    inner_it: torch.Tensor
    total_it: torch.Tensor
    status: torch.Tensor    # [B] bool
    step_size: torch.Tensor
    viol: torch.Tensor
    stop: torch.Tensor      # [B] bool
    trunc_streak: torch.Tensor  # [B] int32


class SLParts(NamedTuple):
    """The SL solver in pieces: ``init`` and ``finish`` convert layouts at
    entry/exit; ``body`` is one solver iteration on the carry."""

    init: Callable    # (xs [B,T,nx], us, ws[, duals, penalty]) -> (_SLCarry, ws_sl)
    body: Callable    # (ws_sl[, solve id]) -> (_SLCarry -> _SLCarry)
    finish: Callable  # (_SLCarry, ws_sl) -> Solution (batch-leading)


def build_kernels(spec: ProblemSpec, use_kernels: bool, dtype) -> list:
    """Build the kernels a solve of ``spec`` on the card runs, their nvcc
    runs started together: the recursion's library at (nx, nu, dtype),
    the derive kernel's where the spec has derive programs and, where the
    line search runs K3/K4 on a generated model, that model's.  Each is
    built once (cached on disk by its text); returns the paths."""
    model = device_model(spec, "cuda") if use_kernels else None
    sources = [model.generated.translation_unit()] if model and model.generated else []
    derive = dk.derive_model(spec, "cuda")
    if derive is not None:
        sources.append(derive.translation_unit(dtype))
    return pk.build((spec.nx, spec.nu), dtypes=(dtype,), sources=sources)


def make_sl_parts(
    spec: ProblemSpec, options: Options = Options(), *,
    device="cuda", dtype=torch.float32, dual_warm_start: bool = False,
) -> SLParts:
    if options.record_traces:
        raise ValueError("SL batched solver does not record traces; "
                         "use the vmap path (record_traces=True)")
    if options.live_progress:
        raise ValueError("SL batched solver does not support live_progress")
    if not options.fused_al_loop:
        raise ValueError("SL batched solver implements the fused AL loop")
    if options.ddp:
        raise ValueError(
            "SL batched solver does not support ddp=True (packed backward "
            "kernel carries no second-derivative stacks); use the vmap path"
        )

    o = options
    nc, T = spec.nc, spec.T
    device = torch.device(device)
    # the rollout-kernel choice is checked now; the pieces that hold device
    # tensors are made at first use, so a solver for the card can be built
    # (and refuse CPU inputs) where there is no card
    use_kernels = select_kernels(spec, o, device)

    @functools.lru_cache(maxsize=None)
    def built():
        if device.type == "cuda":
            build_kernels(spec, use_kernels, dtype)
        return (SLOps(spec, o, device=device, dtype=dtype),
                make_derive_backward_sl(spec, o, device=device))

    def body(ws, solve: int = None):
        """One trip on the carry; ``solve`` is the id its spans carry (a
        new one by default)."""
        ops, derive = built()
        solve = profiling.new_solve() if solve is None else solve
        trips = itertools.count()

        def _body(s: _SLCarry) -> _SLCarry:
            with profiling.annotate("trip", solve=solve, trip=next(trips)):
                K, k, slope, grad, reg = derive(
                    s.xs, s.us, ws, s.duals, s.penalty, s.c, s.reg
                )
                with profiling.annotate("line_search"):
                    live = ~s.stop
                    stop_grad = grad < o.lagrangian_gradient_tolerance
                    # `need`: lanes whose line-search result survives into
                    # the carry (stopped and gradient-converged lanes
                    # discard it)
                    step_n = ops.line_search(
                        s.xs, s.us, ws, K, k, slope, s.J, s.c, s.duals,
                        s.penalty, need=live & ~stop_grad,
                    )
                with profiling.annotate("al_update"):
                    return al_update(s, live, stop_grad, reg, *step_n)

        def al_update(s, live, stop_grad, reg, xs_n, us_n, J_n, c_n, status, step):
            """The stopping tests, the AL round's dual update and the carry
            (stopped lanes keep theirs)."""
            # (the JAX module puts an XLA optimization_barrier here, a
            # workaround for an XLA miscompile; eager PyTorch needs none)
            keep = ~stop_grad
            xs_n = torch.where(keep, xs_n, s.xs)
            us_n = torch.where(keep, us_n, s.us)
            J_n = torch.where(keep, J_n, s.J)
            c_n = torch.where(keep, c_n, s.c)
            status = torch.where(keep, status, s.status)
            step = torch.where(keep, step, s.step_size)

            inner1 = s.inner_it + 1
            round_end = (
                stop_grad
                | (torch.abs(J_n - s.J) < o.objective_tolerance)
                | (~status)
                | (inner1 >= o.max_iterations)
            )
            viol = ops.max_violation(c_n)
            truncated = torch.zeros_like(round_end)
            if o.early_round_iteration_cap is not None:
                # inexact early rounds: penalty-continuation truncation (no
                # ascent, no dual-budget consumption); never in the first
                # round, only with geometric feasibility progress, and at
                # most max_consecutive_truncations in a row
                cap_fired = (
                    (inner1 >= o.early_round_iteration_cap)
                    & (s.al_it > 0)
                    & (s.al_it + 1 < o.max_dual_updates)
                    & (s.trunc_streak < o.max_consecutive_truncations)
                )
                if o.truncation_requires_progress:
                    cap_fired = cap_fired & (
                        viol < o.truncation_progress_factor * s.viol_prev
                    )
                truncated = cap_fired & ~round_end
                round_end = round_end | cap_fired
            feasible = viol <= o.constraint_tolerance
            solve_done = round_end & (
                feasible | (s.al_it + 1 >= o.max_dual_updates)
            )
            if o.early_round_iteration_cap is not None:
                solve_done = solve_done | (
                    s.total_it + 1 >= o.max_iterations * o.max_dual_updates
                )
            if o.max_total_iterations is not None:
                # budget exhausted: stop outright, no dual update
                solve_done = solve_done | (
                    s.total_it + 1 >= o.max_total_iterations
                )
            do_update = round_end & ~solve_done

            new_duals, new_pen = ops.al_transition(
                c_n, viol, s.duals, s.penalty, s.viol_prev, truncated
            )
            duals2 = torch.where(do_update, new_duals, s.duals)
            pen2 = torch.where(do_update, new_pen, s.penalty)
            if nc > 0:
                J_reb = (
                    J_n
                    - ops.al_terms(c_n, s.duals, s.penalty)
                    + ops.al_terms(c_n, duals2, pen2)
                )
                J2 = torch.where(do_update, J_reb, J_n)
            else:
                J2 = J_n

            w = lambda new, old: torch.where(live, new, old)
            return _SLCarry(
                xs=w(xs_n, s.xs), us=w(us_n, s.us),
                duals=w(duals2, s.duals), penalty=w(pen2, s.penalty),
                J=w(J2, s.J), c=w(c_n, s.c), reg=w(reg, s.reg),
                viol_prev=w(
                    torch.where(round_end, viol, s.viol_prev), s.viol_prev
                ),
                al_it=w(
                    s.al_it + (round_end & ~truncated).to(s.al_it.dtype),
                    s.al_it,
                ),
                inner_it=w(
                    torch.where(round_end, torch.zeros_like(inner1), inner1),
                    s.inner_it,
                ),
                total_it=w(s.total_it + 1, s.total_it),
                status=w(status, s.status), step_size=w(step, s.step_size),
                viol=w(viol, s.viol),
                stop=w(solve_done, s.stop),
                trunc_streak=w(
                    torch.where(
                        round_end,
                        torch.where(truncated, s.trunc_streak + 1,
                                    torch.zeros_like(s.trunc_streak)),
                        s.trunc_streak,
                    ),
                    s.trunc_streak,
                ),
            )

        return _body

    def init(xs_b, us_b, ws_b, duals_b=None, pen_b=None):
        ops, _ = built()
        B = xs_b.shape[0]
        xs, us, ws = to_sl(xs_b), to_sl(us_b), to_sl(ws_b)
        if dual_warm_start:
            # carried multipliers/penalties from a previous solve
            duals0, pen0 = to_sl(duals_b), to_sl(pen_b)
        else:
            duals0 = torch.zeros((T, nc, B), dtype=dtype, device=device)
            pen0 = torch.full(
                (T, nc, B), o.initial_constraint_penalty, dtype=dtype,
                device=device,
            )
        J0, c0 = ops.al_objective(xs, us, ws, duals0, pen0)
        zi = torch.zeros(B, dtype=torch.int32, device=device)
        carry = _SLCarry(
            xs=xs, us=us, duals=duals0, penalty=pen0, J=J0, c=c0,
            reg=torch.full((B,), o.regularization_initial, dtype=dtype,
                           device=device),
            viol_prev=torch.full((B,), float("inf"), dtype=dtype, device=device),
            al_it=zi, inner_it=zi, total_it=zi,
            status=torch.ones(B, dtype=torch.bool, device=device),
            step_size=torch.ones(B, dtype=dtype, device=device),
            viol=ops.max_violation(c0),
            stop=torch.zeros(B, dtype=torch.bool, device=device),
            trunc_streak=zi,
        )
        return carry, ws

    def finish(s: _SLCarry, ws) -> Solution:
        ops, derive = built()
        B = s.xs.shape[-1]
        # user-facing violation evaluated fresh at the returned trajectory
        _, c_fin = ops.al_objective(s.xs, s.us, ws, s.duals, s.penalty)
        viol_fin = ops.max_violation(c_fin)
        # exit-consistent gains/gradient about the returned trajectory
        K_f, k_f, _, grad_f, _ = derive(
            s.xs, s.us, ws, s.duals, s.penalty, c_fin, s.reg
        )
        ztr = torch.zeros((B, 1, 1), dtype=dtype, device=device)
        return Solution(
            xs=from_sl(s.xs), us=from_sl(s.us), K=from_sl(K_f), k=from_sl(k_f),
            objective=s.J, gradient_norm=grad_f,
            max_violation=viol_fin, status=s.status,
            iterations=s.total_it, al_iterations=s.al_it,
            step_size=s.step_size,
            duals=from_sl(s.duals), penalty=from_sl(s.penalty), reg=s.reg,
            trace_cost=ztr, trace_gradient_norm=ztr,
            trace_violation=ztr, trace_step_size=ztr,
            trace_mask=torch.zeros((B, 1, 1), dtype=torch.bool, device=device),
            tol_constraint=torch.full((B,), o.constraint_tolerance,
                                      dtype=dtype, device=device),
        )

    return SLParts(init=init, body=body, finish=finish)


def make_batched_solve_sl(
    spec: ProblemSpec, options: Options = Options(), *,
    device="cuda", dtype=torch.float32, dual_warm_start: bool = False,
):
    """Build ``(xs [B,T,nx], us [B,T-1,nu], ws [B,T,npar]) -> Solution``
    (batch-leading).  With ``dual_warm_start`` the callable takes two extra
    batch-leading tensors ``(duals0 [B,T,nc], penalty0 [B,T,nc])``."""
    parts = make_sl_parts(
        spec, options, device=device, dtype=dtype,
        dual_warm_start=dual_warm_start,
    )

    def solve_batch(xs_init, us_init, ws_b, *warm) -> Solution:
        return run_interleaved([sl_trips(parts, xs_init, us_init, ws_b, *warm)])[0]

    return solve_batch


def sl_trips(parts: SLParts, *args):
    """The single-shot SL solve of ``args`` as a generator: it yields after
    queueing each loop trip (before that trip's ``all(stop)`` test, the
    trip's only sync outside the body) and returns the Solution.  A solve
    that finishes adds its entry to ``profiling.solve_log()``."""
    solve = profiling.new_solve()
    with profiling.annotate("init", solve=solve):
        s, ws = parts.init(*args)
    step = parts.body(ws, solve)
    trips = 0
    while True:
        with profiling.sync("sync.stop", solve=solve, trip=trips):
            if bool(s.stop.all()):
                break
        s = step(s)
        trips += 1
        yield
    with profiling.annotate("finish", solve=solve):
        sol = parts.finish(s, ws)
        # every lane is live on its first total_it trips: their sum is the
        # lane-trips the loop worked on
        profiling.log_solve(solve, s.stop.shape[-1], trips, sol.iterations.sum())
    return sol


def run_interleaved(gens):
    """Drive generators in turns, one step of each a round, until each has
    returned; returns their values in order.  With one solve a device,
    every device has its next trip queued before any device's stop flags
    are synced, so the devices overlap on one host thread (the JAX
    package's per-device dispatch, ``core/solve_compact.py::
    solve_sharded``)."""
    results = [None] * len(gens)
    live = list(enumerate(gens))
    while live:
        nxt = []
        for i, g in live:
            try:
                next(g)
                nxt.append((i, g))
            except StopIteration as done:
                results[i] = done.value
        live = nxt
    return results
