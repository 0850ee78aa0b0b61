"""Carry-over between the JAX package and the port.

Acrobot and the other models have no learned parameters, only module
constants, so what crosses between the two packages is the configuration
(``Options``), the batch of initial guesses (and carried duals), and the
solution.  Everything crosses as plain Python values or numpy arrays, so
neither package imports the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.options import Options
from .core.solve import Solution


def options_from_fields(d: dict) -> Options:
    """``Options`` from a field dict, e.g. ``dataclasses.asdict`` of the JAX
    package's ``Options``; unknown fields raise."""
    return Options(**d)


def batch_from_numpy(xs, us, ws, duals=None, penalty=None, *, device,
                     dtype):
    """Batch-leading numpy arrays (xs [B,T,nx], us [B,T-1,nu], ws
    [B,T,npar], optional duals/penalty [B,T,nc]) -> tensors on ``device``
    in ``dtype``, in the argument order of the batched solve."""
    arrays = [xs, us, ws] + [a for a in (duals, penalty) if a is not None]
    return tuple(
        torch.tensor(np.asarray(a), dtype=dtype, device=device)
        for a in arrays
    )


def solution_to_numpy(sol: Solution) -> dict:
    """Every Solution field as a numpy array."""
    return {
        f.name: getattr(sol, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(sol)
    }
