"""Batch parallelism: solve B independent problem instances at once.

Counterpart of ``iterativelqr_tpu/parallel/batch.py``.  Only the SL route
(``core/solve_sl.py``) is ported; the JAX package's other route vmaps the
per-instance solver, which is not ported yet (ROADMAP M10), so options that
would take it raise instead of falling back.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.options import Options
from ..core.solve import Solution
from ..core.spec import ProblemSpec


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


def make_batched_solve_fn(
    spec: ProblemSpec,
    options: Options = Options(),
    callback: Optional[Callable] = None,
    in_axes=(0, 0, 0),
    dual_warm_start: bool = False,
    *,
    device="cpu",
    dtype=torch.float32,
):
    """Build ``(xs_init [B,T,nx], us_init [B,T-1,nu], ws [B,T,npar]) ->
    Solution`` with a leading batch axis on every Solution field.

    ``in_axes`` follows vmap semantics over (xs_init, us_init, ws); None
    marks an argument shared across the batch.  ``dual_warm_start`` adds
    ``(duals0 [B,T,nc], penalty0 [B,T,nc])``.  Inputs must be on ``device``
    in ``dtype``: CPU tensors run every kernel's plain version, CUDA tensors
    the kernels.
    """
    use_sl = options.batched_solver == "sl" or (
        options.batched_solver == "auto" and _sl_eligible(options, callback)
    )
    if not use_sl:
        raise NotImplementedError(
            "these options need the per-instance (vmap) batched solver, which "
            "is not ported yet (ROADMAP M10); the port runs the SL solver, "
            "which needs batched_solver in ('auto', 'sl') and, for 'auto', "
            "record_traces=False, live_progress=False, fused_al_loop=True, "
            "ddp=False, no callback and backward_pass in ('packed', 'auto')"
        )
    from ..core.solve_sl import make_batched_solve_sl

    device = torch.device(device)
    solve_sl = make_batched_solve_sl(
        spec, options, device=device, dtype=dtype,
        dual_warm_start=dual_warm_start,
    )
    eff_in_axes = tuple(in_axes) + ((0, 0) if dual_warm_start else ())

    def solve_batch(*args) -> Solution:
        args = list(args)
        for i, a in enumerate(args):
            if a.dtype != dtype or a.device.type != device.type:
                raise ValueError(
                    f"argument {i}: {a.dtype} on {a.device}, but the solver "
                    f"was built for {dtype} on {device}"
                )
        # vmap-style in_axes: broadcast unbatched (None) arguments
        B = None
        for a, ax in zip(args, eff_in_axes):
            if ax is not None:
                B = a.shape[0]
        for i, ax in enumerate(eff_in_axes):
            if ax is None:
                args[i] = args[i][None].expand((B,) + tuple(args[i].shape))
        return solve_sl(*args)

    return solve_batch


class BatchStats(NamedTuple):
    """Aggregate convergence statistics of a batched Solution."""

    solved_fraction: torch.Tensor
    mean_iterations: torch.Tensor
    max_violation: torch.Tensor
    mean_violation: torch.Tensor
    mean_objective: torch.Tensor
    line_search_failures: torch.Tensor


def batch_stats(sol: Solution, constraint_tolerance=None) -> BatchStats:
    """Defaults to the tolerance the solve ran with (``sol.tol_constraint``);
    pass a value only to re-bucket at a different threshold."""
    if constraint_tolerance is None:
        constraint_tolerance = sol.tol_constraint
    solved = sol.max_violation <= constraint_tolerance
    return BatchStats(
        solved_fraction=solved.to(torch.float32).mean(),
        mean_iterations=sol.iterations.to(torch.float32).mean(),
        max_violation=sol.max_violation.max(),
        mean_violation=sol.max_violation.mean(),
        mean_objective=sol.objective.mean(),
        line_search_failures=(~sol.status).to(torch.int32).sum(),
    )
