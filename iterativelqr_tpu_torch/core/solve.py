"""Per-instance AL-iLQR solver and its batched form.

Counterpart of ``iterativelqr_tpu/core/solve.py`` (its design notes and
citations of the reference live there): ``make_solve_fn`` builds the inner
iLQR loop and the outer augmented-Lagrangian loop, fused into one loop by
default (``fused_al_loop``) or nested, with ``record_traces``,
``dual_warm_start``, a ``backward_impl`` override and a user ``callback``.

The JAX package batches this per-instance program with ``jax.vmap``.  The
port writes the program batch-leading instead (``ops/batching.py``): every
tensor carries a leading lane axis, a ``lax.while_loop`` is a loop over
lanes that runs while any lane's predicate holds and keeps each finished
lane's carry, a ``lax.cond`` or ``jnp.where`` with a per-lane predicate is a
select, and the three ``custom_vmap`` sites (the "auto" backward dispatch,
``ops/pallas_backward.py::make_backward_dispatch`` and the packed
derive+backward ``ops/packed_pipeline.py::make_derive_backward``) get their
unbatched call in the per-instance form and their batched rule in the
batched form.  ``make_solve_fn`` returns a ``SolveFn``: calling it solves
one instance; ``SolveFn.vmap(in_axes)`` is the counterpart of
``jax.vmap(solve, in_axes)`` (in_axes 0 or None per argument).

Every while-loop test is one host sync (``ops/batching.py::LOOP_TESTS``):
per loop trip one test of the solve loop plus one per extra regularization
attempt (``ops/backward.py``).  ``live_progress`` prints each AL round's
values from the host (``utils/printing.py::live_progress_line``), which
costs one more host sync a loop trip.  ``ddp`` (full DDP) adds the
dynamics second derivatives to the derive and runs the reverse scan with
them on every backward attempt, never the "auto" dispatch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import al as al_ops
from ..ops import derivatives as dv
from ..ops import packed_backward as pk
from ..ops.backward import backward_pass
from ..ops.batching import broadcast_lanes, lane_call, select, while_lanes
from ..ops.forward import armijo_slope, line_search, trajectory_sensitivities
from ..utils import profiling
from ..utils.printing import live_progress_line
from .options import Options
from .spec import ProblemSpec


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


@dataclasses.dataclass
class CallbackState:
    """State handed to the user AL callback, a per-instance
    ``(CallbackState) -> CallbackState`` (continuation and homotopy schemes);
    the batched form maps it over lanes with ``torch.func.vmap``."""

    xs: torch.Tensor
    us: torch.Tensor
    ws: torch.Tensor
    duals: torch.Tensor
    penalty: torch.Tensor
    al_iteration: torch.Tensor


class _InnerCarry(NamedTuple):
    xs: torch.Tensor
    us: torch.Tensor
    J: torch.Tensor
    c: torch.Tensor
    K: torch.Tensor
    k: torch.Tensor
    reg: torch.Tensor
    grad_norm: torch.Tensor
    status: torch.Tensor
    stop: torch.Tensor
    it: torch.Tensor
    viol: torch.Tensor
    step_size: torch.Tensor
    tr_cost: torch.Tensor
    tr_grad: torch.Tensor
    tr_viol: torch.Tensor
    tr_step: torch.Tensor
    tr_mask: torch.Tensor


class _FusedCarry(NamedTuple):
    xs: torch.Tensor
    us: torch.Tensor
    ws: torch.Tensor
    duals: torch.Tensor
    penalty: torch.Tensor
    J: torch.Tensor
    c: torch.Tensor
    reg: torch.Tensor
    viol_prev: torch.Tensor
    al_it: torch.Tensor
    inner_it: torch.Tensor
    total_it: torch.Tensor
    status: torch.Tensor
    step_size: torch.Tensor
    viol: torch.Tensor
    stop: torch.Tensor
    trunc_streak: torch.Tensor
    trace_cost: torch.Tensor
    trace_grad: torch.Tensor
    trace_viol: torch.Tensor
    trace_step: torch.Tensor
    trace_mask: torch.Tensor


class _OuterCarry(NamedTuple):
    xs: torch.Tensor
    us: torch.Tensor
    ws: torch.Tensor
    duals: torch.Tensor
    penalty: torch.Tensor
    reg: torch.Tensor
    al_it: torch.Tensor
    stop: torch.Tensor
    total_iters: torch.Tensor
    J: torch.Tensor
    grad_norm: torch.Tensor
    viol: torch.Tensor
    viol_prev: torch.Tensor
    status: torch.Tensor
    step_size: torch.Tensor
    trunc_streak: torch.Tensor
    K: torch.Tensor
    k: torch.Tensor
    trace_cost: torch.Tensor
    trace_grad: torch.Tensor
    trace_viol: torch.Tensor
    trace_step: torch.Tensor
    trace_mask: torch.Tensor


def _set_at(tr, value, *idx):
    """``tr.at[idx].set(value)`` per lane: ``tr`` [B, n_1, .., n_k, ...],
    ``idx`` k per-lane indices [B], ``value`` [B, ...].  An index out of
    range writes nothing (JAX drops such updates)."""
    B, k = tr.shape[0], len(idx)
    hit = torch.ones((B,) + (1,) * k, dtype=torch.bool, device=tr.device)
    for a, ix in enumerate(idx):
        n = tr.shape[1 + a]
        ar = torch.arange(n, device=tr.device).reshape((1,) * (1 + a) + (n,) + (1,) * (k - 1 - a))
        hit = hit & (ar == ix.reshape((B,) + (1,) * k))
    rest = tr.ndim - 1 - k
    hit = hit.reshape(hit.shape + (1,) * rest)
    value = value.reshape((B,) + (1,) * k + tuple(value.shape[1:]))
    return torch.where(hit, value, tr)


class SolveFn:
    """A built solver.  ``solve(xs_init [T,nx], us_init [T-1,nu], ws
    [T,npar])`` (plus ``duals0, penalty0`` [T,nc] with ``dual_warm_start``)
    -> Solution of one instance; ``solve.vmap(in_axes)`` -> the batched
    form, the counterpart of ``jax.vmap(solve, in_axes)``."""

    def __init__(self, run, device, n_args):
        self._run = run
        self.device = device
        self._n_args = n_args

    def _check(self, args):
        if len(args) != self._n_args:
            raise TypeError(f"the solve takes {self._n_args} arguments, got {len(args)}")
        for i, a in enumerate(args):
            if a.device.type != self.device.type:
                raise ValueError(
                    f"argument {i} is on {a.device}, but the solver was built "
                    f"for {self.device}")

    def __call__(self, *args) -> Solution:
        self._check(args)
        sol = self._run(*(a[None] for a in args), batched=False)
        return Solution(**{f.name: getattr(sol, f.name)[0]
                           for f in dataclasses.fields(sol)})

    def vmap(self, in_axes=0):
        """The batched solve: ``in_axes`` is 0 or None, or one of them per
        argument (None = shared by every instance); every Solution field
        gets a leading batch axis."""
        axes = (in_axes,) * self._n_args if in_axes in (0, None) else tuple(in_axes)

        def batched(*args) -> Solution:
            self._check(args)
            return self._run(*broadcast_lanes(args, axes), batched=True)

        return batched


def make_solve_fn(
    spec: ProblemSpec,
    options: Options = Options(),
    callback: Optional[Callable[[CallbackState], CallbackState]] = None,
    dual_warm_start: bool = False,
    backward_impl: Optional[Callable] = None,
    *,
    device="cuda",
) -> SolveFn:
    """Build the solver ``(xs_init, us_init, ws) -> Solution``.

    ``ws`` is the [T, npar] parameter trajectory; duals and penalties reset
    at entry, or, with ``dual_warm_start=True``, come in as two more
    arguments ``(duals0, penalty0)``.  ``backward_impl``: a recursion with
    the ``ops/backward.py::backward_pass_scan`` signature, wrapped in the
    regularization retry (e.g. ``ops/pallas_backward.py::
    make_backward_dispatch``, whose batched rule runs K6a/K6b).  The solve
    runs on ``device`` (the card unless the caller passes "cpu"; CPU
    tensors run every kernel's plain version); the dtype is the inputs'.
    An iteration's phases are spans (``utils/profiling.py``): "derive",
    "augment", "backward", "slope", "line_search" and "al_update" (the
    packed path's first four are ``ops/packed_pipeline.py``'s).
    """
    if backward_impl is not None and options.backward_pass == "packed":
        raise ValueError(
            'backward_impl cannot be combined with backward_pass="packed" '
            "(the packed pipeline owns its own backward kernel)")
    if backward_impl is not None and options.ddp:
        raise ValueError(
            "backward_impl cannot be combined with ddp=True (the DDP terms "
            "supply their own scan recursion)")
    o = options
    nc, T = spec.nc, spec.T
    device = torch.device(device)
    armijo = o.line_search == "armijo"
    rt = o.record_traces

    @functools.lru_cache(maxsize=None)
    def masks(dtype):
        c = functools.partial(dv.device_constant, device=device)
        return dict(x=c(spec.x_mask[:-1], dtype=dtype), u=c(spec.u_mask, dtype=dtype),
                    u_bool=c(spec.u_mask), c=c(spec.c_mask), ineq=c(spec.ineq_mask))

    def al_objective(xs, us, ws, duals, penalty):
        J = dv.total_cost(spec, xs, us, ws)
        c = dv.constraint_values(spec, xs, us, ws)
        if nc > 0:
            J = J + al_ops.al_terms(c, duals, penalty, masks(xs.dtype)["ineq"])
        return J, c

    def viol_of(c):
        m = masks(c.dtype)
        return al_ops.max_violation(c, m["ineq"], m["c"])

    def derive_and_slope_plain(xs, us, ws, duals, penalty, c, reg, batched):
        """Derivative stacks + AL augmentation + backward pass + Armijo
        slope; inputs with leading lane axes."""
        m = masks(xs.dtype)
        with profiling.annotate("derive"):
            fx, fu = dv.dynamics_jacobians(spec, xs, us, ws)
            gx, gu = dv.cost_gradients(spec, xs, us, ws)
            gxx, guu, gux = dv.cost_hessians(spec, xs, us, ws)
            if nc > 0:
                cx, cu = dv.constraint_jacobians(spec, xs, us, ws)
            # full DDP: the dynamics curvature, contracted with Vx(t+1)
            # inside the scan step; the regularization retry re-runs the
            # same recursion with it
            f2 = dv.dynamics_hessians(spec, xs, us, ws) if o.ddp else None
        if nc > 0:
            with profiling.annotate("augment"):
                dgx, dgu, dgxx, dguu, dgux = al_ops.al_gradient_terms(
                    c, cx, cu, duals, penalty, m["ineq"])
                gx, gu = gx + dgx, gu + dgu
                gxx, guu, gux = gxx + dgxx, guu + dguu, gux + dgux
        with profiling.annotate("backward"):
            K, k, Qx, Qu, p, _ok, reg_next = backward_pass(
                fx, fu, gx, gu, gxx, guu, gux, m["u_bool"], reg, o,
                impl=backward_impl, batched=batched, f2=f2)
        with profiling.annotate("slope"):
            # Lagrangian gradient inf-norm over valid dims
            lx = torch.abs(Qx - p) * m["x"]
            lu = torch.abs(Qu) * m["u"]
            grad_norm = torch.maximum(lx.amax(dim=(-2, -1)), lu.amax(dim=(-2, -1)))
            if armijo:
                zx, zu = trajectory_sensitivities(fx, fu, K, k)
                slope = armijo_slope(Qx, Qu, p, zx, zu)
            else:
                slope = torch.zeros_like(grad_norm)
        return K, k, slope, grad_norm, reg_next

    if o.backward_pass == "packed":
        from ..ops.packed_pipeline import make_derive_backward

        # the unbatched call is the per-instance scan path (as the JAX
        # dispatch's); the batched rule the batch-last pipeline and K1/K2
        single = functools.partial(derive_and_slope_plain, batched=False)
        packed = make_derive_backward(spec, o, single, device=device)

        def derive_and_slope(xs, us, ws, duals, penalty, c, reg, batched):
            return lane_call(packed, (xs, us, ws, duals, penalty, c, reg),
                             (True,) * 7, batched)
    else:
        derive_and_slope = derive_and_slope_plain

    def progress(pred, al_it, inner_it, J, grad_norm, viol):
        """``live_progress``: one line per lane where ``pred`` holds, printed
        from the host (one sync, the user's request), as the JAX program
        prints through ``jax.debug.callback``."""
        rows = [v.detach().cpu() for v in (pred, al_it, inner_it, J, grad_norm, viol)]
        for i in torch.nonzero(rows[0]).flatten().tolist():
            live_progress_line(*(v[i] for v in rows[1:]))

    def al_transition(c_fresh, viol_fresh, duals, penalty, viol_prev,
                      truncated):
        """Post-update dual/penalty pair of an AL round boundary (stall-gated
        penalty growth; truncated rounds never ascend); callers gate its
        application per lane."""
        if nc == 0:
            return duals, penalty
        ineq = masks(c_fresh.dtype)["ineq"]
        if o.adaptive_penalty:
            stalled = (viol_fresh > o.penalty_stall_gate * viol_prev) & ~truncated
            scale_eff = torch.where(
                stalled,
                torch.full_like(viol_fresh, o.scaling_penalty * o.scaling_penalty_stalled),
                torch.full_like(viol_fresh, o.scaling_penalty))
        else:
            scale_eff = o.scaling_penalty
        new_duals, new_penalty = al_ops.dual_update(
            c_fresh, duals, penalty, ineq, scale_eff, o.max_penalty)
        if o.adaptive_penalty:
            new_duals = select(stalled, duals, new_duals)
        new_duals = select(truncated, duals, new_duals)
        return new_duals, new_penalty

    def apply_callback(xs, us, ws, duals, penalty, al_it, batched):
        def cb(*a):
            out = callback(CallbackState(*a))
            return (out.xs, out.us, out.ws, out.duals, out.penalty)

        return lane_call(cb, (xs, us, ws, duals, penalty, al_it), (True,) * 6,
                         batched)

    def iterate(xs, us, ws, duals, penalty, J, c, reg, status, step_size,
                batched):
        """Derive + backward at the current nominal, the gradient test, the
        line search; the step is discarded on lanes whose gradient test
        fired.  Returns (xs, us, J, c, status, step, K, k, grad_norm, reg,
        stop_grad)."""
        K, k, slope, grad_norm, reg_n = derive_and_slope(
            xs, us, ws, duals, penalty, c, reg, batched)
        stop_grad = grad_norm < o.lagrangian_gradient_tolerance
        obj_fn = lambda xs_, us_: al_objective(xs_, us_, ws, duals, penalty)
        with profiling.annotate("line_search"):
            xs_n, us_n, J_n, c_n, st, step = line_search(
                spec, obj_fn, xs, us, ws, K, k, slope, J, c, o,
                duals=duals, penalty=penalty)
        # (the JAX module puts an XLA optimization_barrier here, a
        # workaround for an XLA miscompile; eager PyTorch needs none)
        keep = ~stop_grad
        return (select(keep, xs_n, xs), select(keep, us_n, us),
                torch.where(keep, J_n, J), select(keep, c_n, c),
                torch.where(keep, st, status), torch.where(keep, step, step_size),
                K, k, grad_norm, reg_n, stop_grad)

    def lane_init(B, dtype, ref):
        zi = torch.zeros(B, dtype=torch.int32, device=device)
        return dict(
            zi=zi, false=torch.zeros(B, dtype=torch.bool, device=device),
            true=torch.ones(B, dtype=torch.bool, device=device),
            one=torch.ones(B, dtype=dtype, device=device),
            inf=torch.full((B,), float("inf"), dtype=dtype, device=device),
            reg0=torch.full((B,), o.regularization_initial, dtype=dtype, device=device),
            Kz=ref.new_zeros((B, T - 1, spec.nu, spec.nx)),
            kz=ref.new_zeros((B, T - 1, spec.nu)),
        )

    def fused_loop(xs, us, ws, duals0, penalty0, batched) -> _FusedCarry:
        """One fused AL x iLQR loop with per-lane AL state; dual updates are
        applied at each lane's own round boundaries."""
        B, dtype = xs.shape[0], xs.dtype
        n_tr = o.max_iterations if rt else 1
        n_al = o.max_dual_updates if rt else 1
        z = lane_init(B, dtype, xs)
        J0, c0 = al_objective(xs, us, ws, duals0, penalty0)
        zt = torch.zeros((B, n_al, n_tr), dtype=dtype, device=device)
        carry = _FusedCarry(
            xs=xs, us=us, ws=ws, duals=duals0, penalty=penalty0, J=J0, c=c0,
            reg=z["reg0"], viol_prev=z["inf"], al_it=z["zi"], inner_it=z["zi"],
            total_it=z["zi"], status=z["true"], step_size=z["one"],
            viol=viol_of(c0), stop=z["false"], trunc_streak=z["zi"],
            trace_cost=zt, trace_grad=zt, trace_viol=zt, trace_step=zt,
            trace_mask=torch.zeros(zt.shape, dtype=torch.bool, device=device),
        )

        def body(s: _FusedCarry) -> _FusedCarry:
            xs_n, us_n, J_n, c_n, status, step, _K, _k, grad_norm, reg, stop_grad = iterate(
                s.xs, s.us, s.ws, s.duals, s.penalty, s.J, s.c, s.reg,
                s.status, s.step_size, batched)
            with profiling.annotate("al_update"):
                inner1 = s.inner_it + 1
                round_end = (stop_grad | (torch.abs(J_n - s.J) < o.objective_tolerance)
                             | (~status) | (inner1 >= o.max_iterations))
                viol = viol_of(c_n)
                truncated = torch.zeros_like(round_end)
                if o.early_round_iteration_cap is not None:
                    # inexact early rounds: penalty-continuation truncation, never
                    # in the first round, only with geometric feasibility
                    # progress, at most max_consecutive_truncations in a row
                    cap_fired = ((inner1 >= o.early_round_iteration_cap)
                                 & (s.al_it > 0)
                                 & (s.al_it + 1 < o.max_dual_updates)
                                 & (s.trunc_streak < o.max_consecutive_truncations))
                    if o.truncation_requires_progress:
                        cap_fired = cap_fired & (viol < o.truncation_progress_factor * s.viol_prev)
                    truncated = cap_fired & ~round_end
                    round_end = round_end | cap_fired
                feasible = viol <= o.constraint_tolerance
                solve_done = round_end & (feasible | (s.al_it + 1 >= o.max_dual_updates))
                if o.early_round_iteration_cap is not None:
                    solve_done = solve_done | (
                        s.total_it + 1 >= o.max_iterations * o.max_dual_updates)
                if o.max_total_iterations is not None:
                    # budget exhausted: stop outright, no dual update
                    solve_done = solve_done | (s.total_it + 1 >= o.max_total_iterations)
                do_update = round_end & ~solve_done

                new_duals, new_pen = al_transition(c_n, viol, s.duals, s.penalty,
                                                   s.viol_prev, truncated)
                duals2 = select(do_update, new_duals, s.duals)
                pen2 = select(do_update, new_pen, s.penalty)
                ineq = masks(dtype)["ineq"]
                if nc > 0:
                    # rebase the carried objective onto the new AL parameters
                    J_reb = (J_n - al_ops.al_terms(c_n, s.duals, s.penalty, ineq)
                             + al_ops.al_terms(c_n, duals2, pen2, ineq))
                    J2 = torch.where(do_update, J_reb, J_n)
                else:
                    J2 = J_n

                ws2 = s.ws
                if callback is not None:
                    cb = apply_callback(xs_n, us_n, s.ws, duals2, pen2, s.al_it, batched)
                    xs_cb = select(do_update, cb[0], xs_n)
                    us_cb = select(do_update, cb[1], us_n)
                    ws2 = select(do_update, cb[2], s.ws)
                    duals2 = select(do_update, cb[3], duals2)
                    pen2 = select(do_update, cb[4], pen2)
                    # a callback may have changed the problem: re-evaluate
                    J_cb, c_cb = al_objective(xs_cb, us_cb, ws2, duals2, pen2)
                    xs_n, us_n = xs_cb, us_cb
                    J2 = torch.where(do_update, J_cb, J2)
                    c_n = select(do_update, c_cb, c_n)

                if o.live_progress:
                    progress(round_end & ~s.stop, s.al_it, inner1, J_n, grad_norm, viol)

                ai, ii = s.al_it, s.inner_it
                tr = (lambda a, v: _set_at(a, v, ai, ii)) if rt else (lambda a, v: a)
                return _FusedCarry(
                    xs=xs_n, us=us_n, ws=ws2, duals=duals2, penalty=pen2,
                    J=J2, c=c_n, reg=reg,
                    viol_prev=torch.where(round_end, viol, s.viol_prev),
                    al_it=s.al_it + (round_end & ~truncated).to(s.al_it.dtype),
                    inner_it=torch.where(round_end, torch.zeros_like(inner1), inner1),
                    total_it=s.total_it + 1,
                    status=status, step_size=step, viol=viol, stop=solve_done,
                    trunc_streak=torch.where(
                        round_end,
                        torch.where(truncated, s.trunc_streak + 1,
                                    torch.zeros_like(s.trunc_streak)),
                        s.trunc_streak),
                    trace_cost=tr(s.trace_cost, J_n),
                    trace_grad=tr(s.trace_grad, grad_norm),
                    trace_viol=tr(s.trace_viol, viol),
                    trace_step=tr(s.trace_step, step),
                    trace_mask=tr(s.trace_mask, torch.ones_like(s.stop)),
                )

        return while_lanes(lambda s: ~s.stop, body, carry, "solve")

    def ilqr(xs, us, ws, duals, penalty, reg, it_offset, it_cap, viol_gate,
             batched) -> _InnerCarry:
        """Inner iLQR loop (the nested AL loop's): body = derive+backward at
        the current nominal, gradient test, line search."""
        B, dtype = xs.shape[0], xs.dtype
        n_tr = o.max_iterations if rt else 1
        z = lane_init(B, dtype, xs)
        J0, c0 = al_objective(xs, us, ws, duals, penalty)
        zrow = torch.zeros((B, n_tr), dtype=dtype, device=device)
        carry = _InnerCarry(
            xs=xs, us=us, J=J0, c=c0, K=z["Kz"], k=z["kz"], reg=reg,
            grad_norm=z["inf"], status=z["true"], stop=z["false"], it=z["zi"],
            viol=viol_of(c0), step_size=z["one"],
            tr_cost=zrow, tr_grad=zrow, tr_viol=zrow, tr_step=zrow,
            tr_mask=torch.zeros((B, n_tr), dtype=torch.bool, device=device),
        )

        def cond(s: _InnerCarry):
            c = (~s.stop) & (s.it < o.max_iterations)
            if it_cap is not None:
                at_cap = s.it >= it_cap
                if viol_gate is not None:
                    at_cap = at_cap & (s.viol < o.truncation_progress_factor * viol_gate)
                c = c & ~at_cap
            if o.max_total_iterations is not None:
                c = c & (it_offset + s.it < o.max_total_iterations)
            return c

        def body(s: _InnerCarry) -> _InnerCarry:
            xs_n, us_n, J_n, c_n, status, step, K, k, grad_norm, reg_n, stop_grad = iterate(
                s.xs, s.us, ws, duals, penalty, s.J, s.c, s.reg, s.status,
                s.step_size, batched)
            viol = viol_of(c_n)
            stop = (stop_grad | (torch.abs(J_n - s.J) < o.objective_tolerance)
                    | (~status))
            tr = (lambda a, v: _set_at(a, v, s.it)) if rt else (lambda a, v: a)
            return _InnerCarry(
                xs=xs_n, us=us_n, J=J_n, c=c_n, K=K, k=k, reg=reg_n,
                grad_norm=grad_norm, status=status, stop=stop, it=s.it + 1,
                viol=viol, step_size=step,
                tr_cost=tr(s.tr_cost, J_n), tr_grad=tr(s.tr_grad, grad_norm),
                tr_viol=tr(s.tr_viol, viol), tr_step=tr(s.tr_step, step),
                tr_mask=tr(s.tr_mask, torch.ones_like(s.stop)),
            )

        return while_lanes(cond, body, carry, "inner")

    def nested_loop(xs, us, ws, duals0, penalty0, batched) -> _OuterCarry:
        """The nested AL loop (``fused_al_loop=False``): outer dual updates
        around inner iLQR solves."""
        B, dtype = xs.shape[0], xs.dtype
        n_tr = o.max_iterations if rt else 1
        n_al = o.max_dual_updates if rt else 1
        z = lane_init(B, dtype, xs)
        zt = torch.zeros((B, n_al, n_tr), dtype=dtype, device=device)
        zf = torch.zeros(B, dtype=dtype, device=device)
        carry = _OuterCarry(
            xs=xs, us=us, ws=ws, duals=duals0, penalty=penalty0, reg=z["reg0"],
            al_it=z["zi"], stop=z["false"], total_iters=z["zi"], J=zf,
            grad_norm=zf, viol=zf, viol_prev=z["inf"], status=z["true"],
            step_size=z["one"], trunc_streak=z["zi"], K=z["Kz"], k=z["kz"],
            trace_cost=zt, trace_grad=zt, trace_viol=zt, trace_step=zt,
            trace_mask=torch.zeros(zt.shape, dtype=torch.bool, device=device),
        )
        cap = o.early_round_iteration_cap

        def cond(s: _OuterCarry):
            c = (~s.stop) & (s.al_it < o.max_dual_updates)
            if cap is not None:
                # truncated rounds don't consume the dual budget
                c = c & (s.total_iters < o.max_iterations * o.max_dual_updates)
            return c

        def body(s: _OuterCarry) -> _OuterCarry:
            it_cap = None
            if cap is not None:
                # the first, the last possible and a round after
                # max_consecutive_truncations truncations run to
                # max_iterations; earlier rounds are capped
                it_cap = torch.where(
                    (s.al_it == 0) | (s.al_it + 1 >= o.max_dual_updates)
                    | (s.trunc_streak >= o.max_consecutive_truncations),
                    torch.full_like(s.al_it, o.max_iterations),
                    torch.full_like(s.al_it, cap))
            inner = ilqr(
                s.xs, s.us, s.ws, s.duals, s.penalty, s.reg, s.total_iters,
                it_cap,
                s.viol_prev if (it_cap is not None and o.truncation_requires_progress) else None,
                batched)
            with profiling.annotate("al_update"):
                # stop and dual decisions on constraints evaluated fresh at the
                # inner solution
                c_fresh = dv.constraint_values(spec, inner.xs, inner.us, s.ws)
                viol_fresh = viol_of(c_fresh)
                stop = viol_fresh <= o.constraint_tolerance
                if o.max_total_iterations is not None:
                    stop = stop | (s.total_iters + inner.it >= o.max_total_iterations)
                truncated = torch.zeros_like(stop)
                if it_cap is not None:
                    # round ended by the cap, not by converging
                    truncated = ((~inner.stop) & (inner.it >= it_cap)
                                 & (it_cap < o.max_iterations)
                                 & (inner.it < o.max_iterations))
                if nc > 0:
                    new_duals, new_penalty = al_transition(
                        c_fresh, viol_fresh, s.duals, s.penalty, s.viol_prev, truncated)
                    duals = select(stop, s.duals, new_duals)
                    penalty = select(stop, s.penalty, new_penalty)
                else:
                    duals, penalty = s.duals, s.penalty
                    stop = torch.ones_like(stop)
                if o.live_progress:
                    progress(cond(s), s.al_it, inner.it, inner.J, inner.grad_norm,
                             viol_fresh)
                ws_next = s.ws
                xs_next, us_next = inner.xs, inner.us
                if callback is not None:
                    cb = apply_callback(inner.xs, inner.us, s.ws, duals, penalty,
                                        s.al_it, batched)
                    # applied only while the outer loop continues
                    xs_next = select(stop, xs_next, cb[0])
                    us_next = select(stop, us_next, cb[1])
                    ws_next = select(stop, s.ws, cb[2])
                    duals = select(stop, duals, cb[3])
                    penalty = select(stop, penalty, cb[4])
                tr = (lambda a, v: _set_at(a, v, s.al_it)) if rt else (lambda a, v: a)
                return _OuterCarry(
                    xs=xs_next, us=us_next, ws=ws_next, duals=duals, penalty=penalty,
                    reg=inner.reg,
                    al_it=s.al_it + torch.where(truncated, 0, 1).to(s.al_it.dtype),
                    stop=stop, total_iters=s.total_iters + inner.it,
                    J=inner.J, grad_norm=inner.grad_norm, viol=viol_fresh,
                    viol_prev=viol_fresh, status=inner.status,
                    step_size=inner.step_size,
                    trunc_streak=torch.where(truncated, s.trunc_streak + 1,
                                             torch.zeros_like(s.trunc_streak)),
                    K=inner.K, k=inner.k,
                    trace_cost=tr(s.trace_cost, inner.tr_cost),
                    trace_grad=tr(s.trace_grad, inner.tr_grad),
                    trace_viol=tr(s.trace_viol, inner.tr_viol),
                    trace_step=tr(s.trace_step, inner.tr_step),
                    trace_mask=tr(s.trace_mask, inner.tr_mask),
                )

        return while_lanes(cond, body, carry, "solve")

    def finish(xs, us, ws, duals, penalty, reg, J, status, step_size,
               total_iters, al_it, tr_cost, tr_grad, tr_viol, tr_step, tr_mask,
               batched) -> Solution:
        # the violation of the returned trajectory, evaluated fresh, and
        # gains/gradient re-derived about it
        c_final = dv.constraint_values(spec, xs, us, ws)
        viol_final = viol_of(c_final)
        K_f, k_f, _, grad_f, _ = derive_and_slope(
            xs, us, ws, duals, penalty, c_final, reg, batched)
        return Solution(
            xs=xs, us=us, K=K_f, k=k_f, objective=J, gradient_norm=grad_f,
            max_violation=viol_final, status=status, iterations=total_iters,
            al_iterations=al_it, step_size=step_size, duals=duals,
            penalty=penalty, reg=reg, trace_cost=tr_cost,
            trace_gradient_norm=tr_grad, trace_violation=tr_viol,
            trace_step_size=tr_step, trace_mask=tr_mask,
            tol_constraint=torch.full(J.shape, o.constraint_tolerance,
                                      dtype=J.dtype, device=device),
        )

    # the recursion's kernels on the card: built at a solve's start (the
    # dtype is the inputs'), before its first trip
    riccati = device.type == "cuda" and (
        o.backward_pass == "packed"
        or getattr(backward_impl, "riccati_kernels", False))

    def run(xs_init, us_init, ws, duals0=None, penalty0=None, *, batched):
        B, dtype = xs_init.shape[0], xs_init.dtype
        if riccati and batched:
            pk.library(spec.nx, spec.nu, dtype)
        if duals0 is None:
            duals0 = torch.zeros((B, T, nc), dtype=dtype, device=device)
            penalty0 = torch.full((B, T, nc), o.initial_constraint_penalty,
                                  dtype=dtype, device=device)
        if o.fused_al_loop:
            s = fused_loop(xs_init, us_init, ws, duals0, penalty0, batched)
            return finish(s.xs, s.us, s.ws, s.duals, s.penalty, s.reg, s.J,
                          s.status, s.step_size, s.total_it, s.al_it,
                          s.trace_cost, s.trace_grad, s.trace_viol,
                          s.trace_step, s.trace_mask, batched)
        s = nested_loop(xs_init, us_init, ws, duals0, penalty0, batched)
        return finish(s.xs, s.us, s.ws, s.duals, s.penalty, s.reg, s.J,
                      s.status, s.step_size, s.total_iters, s.al_it,
                      s.trace_cost, s.trace_grad, s.trace_viol, s.trace_step,
                      s.trace_mask, batched)

    return SolveFn(run, device, 5 if dual_warm_start else 3)
