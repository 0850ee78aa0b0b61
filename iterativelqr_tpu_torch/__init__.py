"""iterativelqr_tpu_torch: the PyTorch / CUDA port of iterativelqr_tpu.

A second package beside the JAX reference, with the same core/ ops/
parallel/ models/ layout and module names.  It imports torch and never jax.
The batched AL-iLQR solve runs on CPU tensors through plain PyTorch and on
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
from .core.solve import Solution  # noqa: E402
from .core.spec import Constraint, Cost, Dynamics, ProblemSpec, build_spec  # noqa: E402
from .parallel.batch import BatchStats, batch_stats, make_batched_solve_fn  # noqa: E402

__all__ = [
    "BatchStats",
    "Constraint",
    "Cost",
    "Dynamics",
    "Options",
    "ProblemSpec",
    "Solution",
    "batch_stats",
    "build_spec",
    "make_batched_solve_fn",
]
