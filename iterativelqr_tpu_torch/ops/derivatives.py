"""Horizon-stacked evaluation of stage functions.

Counterpart of ``iterativelqr_tpu/ops/derivatives.py``; only
``constraint_values`` is ported so far (the batched solver derives its stacks
in ``ops/packed_pipeline.py``).  Each stage type is evaluated over its
statically known timesteps with ``torch.func.vmap`` and the rows are put
back in time order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from ..core.spec import ProblemSpec


def _merge_groups(results, groups):
    """Rows of per-group results (each a tensor or a tuple of tensors with
    the group's timesteps on axis 0) back in time order.  ``groups``
    partition the rows.  A concatenation and one gather, so the merge also
    works under an outer ``vmap`` (an in-place scatter would not)."""
    inv = torch.as_tensor(np.argsort(np.concatenate(groups)))

    def merge(parts):
        cat = torch.cat(parts, dim=0)
        return cat[inv.to(cat.device)]

    if isinstance(results[0], tuple):
        return tuple(merge(parts) for parts in zip(*results))
    return merge(results)


def _grouped(fns, groups, args):
    """vmap each fns[g] over its timestep group, rows back in time order."""
    if len(fns) == 1:
        return vmap(fns[0])(*args)
    results = []
    for fn, idx in zip(fns, groups):
        idx_t = torch.as_tensor(idx, device=args[0].device)
        results.append(vmap(fn)(*(a[idx_t] for a in args)))
    return _merge_groups(results, groups)


def _us_full(spec: ProblemSpec, us):
    """Actions padded with a terminal zero row: terminal stage functions see
    u = 0 (their true action dim is 0)."""
    return torch.cat([us, us.new_zeros((1, spec.nu))], dim=0)


def constraint_values(spec: ProblemSpec, xs, us, ws):
    """c [T,nc] for one instance (xs [T,nx], us [T-1,nu], ws [T,npar]);
    padded rows are exactly zero (reference: src/constraints.jl:66-73)."""
    if spec.nc == 0:
        return xs.new_zeros((spec.T, 0))
    uf = _us_full(spec, us)
    return _grouped(spec.con_eval, spec.con_groups, (xs, uf, ws))
