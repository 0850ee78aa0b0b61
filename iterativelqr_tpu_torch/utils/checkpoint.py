"""Checkpoint / resume for solver and MPC state.

Counterpart of ``iterativelqr_tpu/utils/checkpoint.py``: solver state is an
explicit structure of tensors (a ``Solution``, an ``MPCState``, NamedTuples
and tuples of tensors), so checkpointing is warm starting: save it, load
it, seed the next solve.  The leaves are flattened in a fixed order
(dataclass fields and tuple entries in order, dict keys sorted) and stored
as an index-keyed ``.npz``; ``load`` rebuilds the structure from a ``like``
template, each leaf on ``like``'s device in its dtype.  The JAX module's
orbax route (directory checkpoints) has no counterpart.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch


def tree_leaves(state: Any) -> list:
    """The leaves of ``state`` in the fixed order ``save`` stores them."""
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return [leaf for f in dataclasses.fields(state)
                for leaf in tree_leaves(getattr(state, f.name))]
    if isinstance(state, (tuple, list)):
        return [leaf for s in state for leaf in tree_leaves(s)]
    if isinstance(state, dict):
        return [leaf for k in sorted(state) for leaf in tree_leaves(state[k])]
    return [state]


def _rebuild(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaves) for f in dataclasses.fields(like)})
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(s, leaves) for s in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(s, leaves) for s in like)
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    value = next(leaves)
    if isinstance(like, torch.Tensor):
        if tuple(value.shape) != tuple(like.shape):
            raise ValueError(f"a checkpoint leaf of shape {value.shape} where the "
                             f"template has {tuple(like.shape)}")
        return torch.as_tensor(value).to(device=like.device, dtype=like.dtype)
    return type(like)(value) if isinstance(like, (int, float, bool)) else value


def save(path: str, state: Any) -> str:
    """Save ``state``'s leaves as ``path`` (``.npz`` appended if missing);
    returns the file's path."""
    flat = {}
    for i, leaf in enumerate(tree_leaves(state)):
        flat[f"leaf_{i:08d}"] = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                                 else np.asarray(leaf))
    out = path if path.endswith(".npz") else path + ".npz"
    np.savez(out, **flat)
    return out


def load(path: str, like: Any) -> Any:
    """Load a state saved by ``save``; ``like`` gives the structure, and
    each tensor leaf's shape, device and dtype."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is a directory: an orbax checkpoint, which this package does "
            "not read; save the state as .npz with utils/checkpoint.save")
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        # numeric order of the leaf index: a lexicographic sort misorders
        # mixed pad widths (leaf_10000 < leaf_2000)
        keys = sorted(data.files, key=lambda s: int(s.rsplit("_", 1)[1]))
        arrays = [data[k] for k in keys]
    n_like = len(tree_leaves(like))
    if len(arrays) != n_like:
        raise ValueError(f"{path!r} holds {len(arrays)} leaves, the template {n_like}")
    return _rebuild(like, iter(arrays))
