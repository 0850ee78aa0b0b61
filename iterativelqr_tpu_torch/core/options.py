"""Solver options.

Same fields, defaults and validation as the JAX package's
``iterativelqr_tpu/core/options.py``, which also carries the measured
rationale of every knob.  The dataclass is frozen so an ``Options`` can be
shared between solves without being mutated.

Options the SL batched solver does not run (``record_traces``, the nested
AL loop, a callback, ``ddp``) take the per-instance solver's vmap route, as
in the reference.  ``scan_unroll`` is
a JAX scan knob that the port's loops ignore.  ``forward_kernel`` keeps the
reference's values:
"pallas" runs the CUDA rollout kernels K3/K4 (``ops/sl_forward_kernel.py``),
"scan" the plain loops, "auto" the kernels on the card where the spec
qualifies.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Options:
    # --- reference-parity options (src/options.jl:1-14) ---
    line_search: str = "armijo"  # "armijo" | "none"
    max_iterations: int = 100
    max_dual_updates: int = 10
    min_step_size: float = 1.0e-5
    objective_tolerance: float = 1.0e-3
    lagrangian_gradient_tolerance: float = 1.0e-3
    constraint_tolerance: float = 5.0e-3
    constraint_norm: float = math.inf
    initial_constraint_penalty: float = 1.0
    scaling_penalty: float = 10.0
    max_penalty: float = 1.0e8
    verbose: bool = False

    # --- Armijo parameters (reference: src/forward_pass.jl:4-6) ---
    armijo_c1: float = 1.0e-4
    max_line_search_iterations: int = 25

    # --- adaptive Quu regularization ---
    regularization_initial: float = 0.0
    regularization_min: float = 1.0e-6
    regularization_max: float = 1.0e12
    regularization_scale: float = 10.0
    max_regularization_steps: int = 20

    # --- stall-gated AL penalty schedule ---
    adaptive_penalty: bool = True
    penalty_stall_gate: float = 0.25
    scaling_penalty_stalled: float = 100.0

    # --- loop structure and diagnostics ---
    fused_al_loop: bool = True
    live_progress: bool = False
    record_traces: bool = True
    scan_unroll: int = 4  # a JAX scan knob; the port's loops ignore it

    # --- implementation selectors ---
    backward_pass: str = "auto"

    # --- inexact early AL rounds and their safety gates ---
    early_round_iteration_cap: "int | None" = None
    truncation_requires_progress: bool = True
    truncation_progress_factor: float = 0.75
    max_consecutive_truncations: int = 16

    # --- hard total inner-iteration budget (None = unlimited) ---
    max_total_iterations: "int | None" = None

    # --- line-search rollout selector: "scan" | "pallas" | "auto" ---
    forward_kernel: str = "scan"

    # --- constraint-aware line-search acceptance ---
    constraint_aware_acceptance: bool = False

    # --- full DDP (second-order dynamics terms) ---
    ddp: bool = False

    # --- batched-solver selector ---
    batched_solver: str = "auto"

    def __post_init__(self):
        if self.line_search not in ("armijo", "none"):
            raise ValueError(f"unknown line_search {self.line_search!r}")
        if self.backward_pass == "pallas":
            raise ValueError(
                'backward_pass="pallas" was demoted to an internal '
                'experiment in the JAX package — use "packed" (its measured '
                "successor)"
            )
        if self.backward_pass not in (
            "scan", "associative", "packed", "auto"
        ):
            raise ValueError(f"unknown backward_pass {self.backward_pass!r}")
        if self.batched_solver not in ("auto", "vmap", "sl"):
            raise ValueError(f"unknown batched_solver {self.batched_solver!r}")
        if self.ddp and self.backward_pass in ("associative", "packed"):
            raise ValueError(
                f'ddp=True requires the sequential scan recursion (the DDP '
                f'contraction uses Vx(t+1) inside the step); '
                f'backward_pass={self.backward_pass!r} is incompatible — '
                'use "scan" or "auto"'
            )
        if self.ddp and self.batched_solver == "sl":
            raise ValueError(
                "ddp=True is not supported by the SL batched solver (its "
                'packed backward kernel carries no second-derivative '
                'stacks); use batched_solver="vmap" or "auto"'
            )
        if self.forward_kernel not in ("auto", "pallas", "scan"):
            raise ValueError(f"unknown forward_kernel {self.forward_kernel!r}")
        if self.max_total_iterations is not None and self.max_total_iterations < 1:
            raise ValueError("max_total_iterations must be >= 1")
        if not (0.0 < self.truncation_progress_factor <= 1.0):
            raise ValueError(
                "truncation_progress_factor must be in (0, 1]"
            )
        if (self.early_round_iteration_cap is not None
                and self.early_round_iteration_cap < 1):
            raise ValueError("early_round_iteration_cap must be >= 1")
        if self.max_consecutive_truncations < 1:
            raise ValueError("max_consecutive_truncations must be >= 1")

    @property
    def num_step_sizes(self) -> int:
        """Number of line-search candidates alpha_j = 0.5**j.

        Reproduces the reference's serial halving loop
        (src/forward_pass.jl:28-54): step sizes from 1.0 downward while
        alpha >= min_step_size, capped at max_line_search_iterations.
        """
        if self.min_step_size <= 0:
            return self.max_line_search_iterations
        n = int(math.floor(math.log2(1.0 / self.min_step_size))) + 1
        # guard: 0.5**(n-1) must be >= min_step_size
        while n > 1 and 0.5 ** (n - 1) < self.min_step_size:
            n -= 1
        return min(n, self.max_line_search_iterations)
