"""``jax.vmap`` of the per-instance solver, written out.

The JAX package batches its per-instance solver with ``jax.vmap``; the port
writes that program batch-leading instead: every tensor of the solver
carries a leading lane axis, and the pieces here reproduce what ``vmap``
makes of the JAX constructs.

* ``while_lanes`` is ``lax.while_loop`` under ``vmap`` with a per-lane
  predicate: the body runs on every lane while any lane's predicate holds,
  and each lane whose predicate failed keeps its carry (a select), so each
  lane follows its own per-instance iterates.  Each test of the predicate
  is one host sync; ``LOOP_TESTS`` counts them by loop name.
* ``select`` is ``jnp.where`` with a per-lane predicate, broadcast over a
  lane's trailing axes; a ``lax.cond`` with a per-lane predicate becomes a
  select between both branches.
* ``custom_vmap`` and ``lane_call`` are ``jax.custom_batching.custom_vmap``:
  a function with an unbatched call and a rule for lane-batched calls,
  called where the JAX program calls it.  ``lane_call`` runs the unbatched
  call in the per-instance form of the solver (one lane) and the rule in
  the batched form; a plain function with no rule is mapped over lanes with
  ``torch.func.vmap`` (JAX's default batching of it).
* ``lane_eval`` evaluates a per-instance stage function (1-D ``x``, ``u``,
  ``w``) over any leading lane axes, with one ``torch.func.vmap`` over the
  flattened lanes.
"""

from __future__ import annotations

import collections
import math

import torch
from torch.func import vmap

# tests of each lane-batched while loop's predicate (host syncs), by loop
LOOP_TESTS = collections.Counter()


def select(pred, new, old):
    """``where(pred, new, old)`` with ``pred`` over the leading lane axes of
    ``new``/``old``."""
    return torch.where(pred.reshape(pred.shape + (1,) * (new.ndim - pred.ndim)),
                       new, old)


def tree_select(pred, new, old):
    """``select`` over a (named) tuple of tensors or nested tuples."""
    if isinstance(new, tuple):
        fields = [tree_select(pred, n, o) for n, o in zip(new, old)]
        return type(new)(*fields) if hasattr(new, "_fields") else tuple(fields)
    return select(pred, new, old)


def while_lanes(cond, body, carry, name):
    """``lax.while_loop(cond, body, carry)`` under ``vmap``: ``cond`` returns
    a per-lane predicate; the body runs on all lanes while any holds, and
    lanes whose predicate failed keep their carry."""
    while True:
        active = cond(carry)
        LOOP_TESTS[name] += 1
        if not bool(active.any()):
            return carry
        carry = tree_select(active, body(carry), carry)


class custom_vmap:
    """Counterpart of ``jax.custom_batching.custom_vmap``: ``fn`` is the
    unbatched call; ``def_vmap`` registers ``rule(axis_size, in_batched,
    *args)``, which receives the lane-batched arguments (``in_batched[i]``
    says whether argument i carries the leading lane axis) and returns
    outputs that all carry it."""

    def __init__(self, fn):
        self.fn = fn
        self.rule = None

    def __call__(self, *args):
        return self.fn(*args)

    def def_vmap(self, rule):
        self.rule = rule
        return rule


def lane_call(fn, args, in_batched, batched: bool):
    """Call ``fn`` where the per-instance JAX program calls it.

    ``args[i]`` carries the leading lane axis where ``in_batched[i]``; the
    outputs (a tuple) always carry it.  In the per-instance form (``batched`` False,
    one lane) this is the unbatched call on lane 0; in the batched form the
    ``custom_vmap`` rule of ``fn``, or ``torch.func.vmap`` of ``fn`` when it
    has none."""
    if not batched:
        out = fn(*(a[0] if b else a for a, b in zip(args, in_batched)))
        return tuple(o[None] for o in out)
    rule = getattr(fn, "rule", None)
    if rule is not None:
        axis_size = next(a.shape[0] for a, b in zip(args, in_batched) if b)
        return rule(axis_size, tuple(in_batched), *args)
    return vmap(fn, in_dims=tuple(0 if b else None for b in in_batched))(*args)


def broadcast_lanes(args, in_axes):
    """vmap ``in_axes`` (0 or None per argument): unbatched arguments are
    expanded over the batch, so every argument carries the lane axis."""
    args = list(args)
    if len(in_axes) != len(args):
        raise ValueError(f"in_axes has {len(in_axes)} entries for {len(args)} arguments")
    if any(ax not in (0, None) for ax in in_axes):
        raise ValueError(f"in_axes entries must be 0 or None, got {tuple(in_axes)}")
    sizes = {a.shape[0] for a, ax in zip(args, in_axes) if ax is not None}
    if len(sizes) != 1:
        raise ValueError(f"batched arguments need one leading size, got {sorted(sizes)}")
    (B,) = sizes
    for i, ax in enumerate(in_axes):
        if ax is None:
            args[i] = args[i][None].expand((B,) + tuple(args[i].shape))
    return args


def lane_eval(fn, *args):
    """Per-instance ``fn(x, u, w)`` (1-D arguments) over the leading lane
    axes of its arguments, broadcast against each other; outputs keep the
    lane axes."""
    lanes = torch.broadcast_shapes(*(a.shape[:-1] for a in args))
    n = math.prod(lanes)
    flat = [a.expand(lanes + a.shape[-1:]).reshape((n,) + a.shape[-1:])
            for a in args]
    out = vmap(fn)(*flat)
    if isinstance(out, tuple):
        return tuple(o.reshape(lanes + o.shape[1:]) for o in out)
    return out.reshape(lanes + out.shape[1:])
