"""Batch parallelism: solve B independent problem instances at once.

Counterpart of ``iterativelqr_tpu/parallel/batch.py``, with both of its
routes: the SL solver (``core/solve_sl.py``, the whole loop batch-last) for
options it supports, and the batched form of the per-instance solver
(``core/solve.py::make_solve_fn(...).vmap``, the counterpart of
``jax.vmap``) for the rest: a literal ``Options()`` (record_traces=True),
``batched_solver="vmap"``, the nested AL loop, or a callback.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.options import Options
from ..core.solve import Solution, make_solve_fn
from ..core.spec import ProblemSpec
from ..ops.batching import broadcast_lanes


def _sl_eligible(options: Options, callback) -> bool:
    """Options the SL batched solver supports (same rule as the JAX
    package: a literal ``Options()`` has record_traces=True and is not
    eligible)."""
    return (
        options.backward_pass in ("packed", "auto")
        and options.fused_al_loop
        and not options.record_traces
        and not options.live_progress
        and not options.ddp
        and callback is None
        and options.line_search in ("armijo", "none")
    )


def _use_sl(options: Options, callback) -> bool:
    """The batched route: the SL solver for ``batched_solver="sl"``, and
    for "auto" wherever ``_sl_eligible`` holds; the vmap route otherwise."""
    return options.batched_solver == "sl" or (
        options.batched_solver == "auto" and _sl_eligible(options, callback))


def make_batched_solve_fn(
    spec: ProblemSpec,
    options: Options = Options(),
    callback: Optional[Callable] = None,
    in_axes=(0, 0, 0),
    dual_warm_start: bool = False,
    *,
    device="cuda",
    dtype=torch.float32,
):
    """Build ``(xs_init [B,T,nx], us_init [B,T-1,nu], ws [B,T,npar]) ->
    Solution`` with a leading batch axis on every Solution field.

    ``in_axes`` follows vmap semantics over (xs_init, us_init, ws); None
    marks an argument shared across the batch.  ``dual_warm_start`` adds
    ``(duals0 [B,T,nc], penalty0 [B,T,nc])``.  Inputs must be on ``device``
    in ``dtype``.  The solve runs on the card unless the caller passes
    ``device="cpu"``; CPU tensors run every kernel's plain version, CUDA
    tensors the kernels.  The route follows ``options.batched_solver`` as
    in the JAX package, but "auto" takes the SL solver wherever
    ``_sl_eligible`` holds, on any device: the JAX package takes it only on
    a TPU or with ``interpret=True``, and the port's CPU path (the kernels'
    plain versions) plays the part of ``interpret=True``.
    """
    use_sl = _use_sl(options, callback)
    device = torch.device(device)
    eff_in_axes = tuple(in_axes) + ((0, 0) if dual_warm_start else ())
    if use_sl:
        from ..core.solve_sl import make_batched_solve_sl

        solve_sl = make_batched_solve_sl(
            spec, options, device=device, dtype=dtype,
            dual_warm_start=dual_warm_start,
        )
        run = lambda *args: solve_sl(*broadcast_lanes(args, eff_in_axes))
    else:
        run = make_solve_fn(spec, options, callback,
                            dual_warm_start=dual_warm_start,
                            device=device).vmap(eff_in_axes)

    def solve_batch(*args) -> Solution:
        for i, a in enumerate(args):
            if a.dtype != dtype or a.device.type != device.type:
                raise ValueError(
                    f"argument {i}: {a.dtype} on {a.device}, but the solver "
                    f"was built for {dtype} on {device}"
                )
        return run(*args)

    return solve_batch


class BatchStats(NamedTuple):
    """Aggregate convergence statistics of a batched Solution."""

    solved_fraction: torch.Tensor
    mean_iterations: torch.Tensor
    max_violation: torch.Tensor
    mean_violation: torch.Tensor
    mean_objective: torch.Tensor
    line_search_failures: torch.Tensor


def _partial_stats(sol: Solution, constraint_tolerance=None):
    """The sums, counts and maximum from which ``BatchStats`` reduce, so
    that one batch and shards of it (added, maxima taken) share one code
    path: (sums [solved, iterations, violation, objective, failures,
    lanes] in the solution's dtype, max violation [1])."""
    if constraint_tolerance is None:
        constraint_tolerance = sol.tol_constraint
    dt = sol.objective.dtype
    solved = (sol.max_violation <= constraint_tolerance).to(torch.float32).sum()
    sums = torch.stack([
        solved.to(dt),
        sol.iterations.to(torch.float32).sum().to(dt),
        sol.max_violation.sum(), sol.objective.sum(),
        (~sol.status).to(dt).sum(),
        torch.tensor(float(sol.xs.shape[0]), dtype=dt, device=sol.xs.device)])
    return sums, sol.max_violation.max().reshape(1)


def _stats_from(sums, vmax) -> BatchStats:
    solved, iters, viol, obj, failures, lanes = sums.unbind()
    return BatchStats(
        solved_fraction=solved.to(torch.float32) / lanes.to(torch.float32),
        mean_iterations=iters.to(torch.float32) / lanes.to(torch.float32),
        max_violation=vmax[0],
        mean_violation=viol / lanes,
        mean_objective=obj / lanes,
        line_search_failures=failures.to(torch.int32),
    )


def batch_stats(sol: Solution, constraint_tolerance=None) -> BatchStats:
    """Defaults to the tolerance the solve ran with (``sol.tol_constraint``);
    pass a value only to re-bucket at a different threshold."""
    return _stats_from(*_partial_stats(sol, constraint_tolerance))
