"""iterativelqr_tpu_torch: the PyTorch / CUDA port of iterativelqr_tpu.

A second package beside the JAX reference, with the same core/ ops/
parallel/ models/ utils/ layout and module names.  It imports torch and
never jax.  The ``Solver`` shell, the per-instance solver (``make_solve_fn``,
with its batched form; its default backward pass on one instance is the
associative scan), the batched AL-iLQR solve and its straggler-compaction
loop (``core/solve_compact.py::make_compacted_solve_fn``), and the
parameter sensitivities run on CPU tensors through plain PyTorch and on
CUDA tensors through the hand-written kernels in ``csrc/`` (built with nvcc
at first use, ``_build.py``).
"""

import torch

# Full-precision float32 products everywhere.  The reference forces full-f32
# matmuls because reduced-precision products broke Riccati conditioning;
# TF32 keeps about three decimal digits, so it is switched off explicitly
# for both matmuls and cuDNN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .core.options import Options  # noqa: E402
from .core.solve import CallbackState, Solution, make_solve_fn  # noqa: E402
from .core.solver import Solver  # noqa: E402
from .core.spec import Constraint, Cost, Dynamics, ProblemSpec, build_spec  # noqa: E402
from .ops.rollout import rollout  # noqa: E402
from .ops.sensitivity import parameter_gradient, solution_parameter_gradient  # noqa: E402
from .parallel.batch import BatchStats, batch_stats, make_batched_solve_fn  # noqa: E402

__all__ = [
    "BatchStats",
    "CallbackState",
    "Constraint",
    "Cost",
    "Dynamics",
    "Options",
    "ProblemSpec",
    "Solution",
    "Solver",
    "batch_stats",
    "build_spec",
    "make_batched_solve_fn",
    "make_solve_fn",
    "parameter_gradient",
    "rollout",
    "solution_parameter_gradient",
]
