"""Batch sharding of batched solves over devices and processes.

Counterpart of ``iterativelqr_tpu/parallel/shard.py``.  Problem instances
are independent, so the batch splits into contiguous shards, one a mesh
entry, each solved on its device; only the aggregate statistics are
reduced across shards.  The JAX package expresses this with a
``NamedSharding`` and lets XLA insert the collectives; here:

* ``Mesh`` is an ordered device list along one named axis.  Entries may
  repeat a device (two shards on one card run there in turns).
* The SL route (``core/solve_sl.py``) advances every shard trip by trip in
  turns (``solve_sl.py::run_interleaved``): each device has its next trip
  queued before any device's ``all(stop)`` test, so devices overlap on one
  host thread.  The vmap route (``make_solve_fn(...).vmap``) syncs inside
  its own loops and solves its shards one after the other, so in one
  process only one card works at a time.  A host thread a card is no way
  out: ``torch.func``'s forward-mode AD keeps one process-wide level, and
  two threads deriving at once fail ("no level exists").  Several cards
  overlap on this route as one process a card (``global_batch_from_local``
  under ``distributed_initialize``).
* ``BatchStats`` are reduced from per-shard partial sums: counts and sums
  are added and maxima taken, never recomputed from the concatenation.
* Under an initialized ``torch.distributed`` process group every rank
  holds its own rows of the global batch (``global_batch_from_local``) on
  its own mesh entries; the partial sums are reduced with ``all_reduce``
  (SUM / MAX) and every Solution field is gathered with ``all_gather``,
  so every rank returns the global Solution and the global stats, as the
  JAX package's global arrays are seen from every process.  The gloo
  backend gathers through the host (it has no CUDA ``all_gather``).

Per-lane results equal the single-device solve bitwise: lanes are
independent, only the batch shapes they ride differ.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.options import Options
from ..core.solve import Solution
from ..core.spec import ProblemSpec
from .batch import _partial_stats, _stats_from, _use_sl, make_batched_solve_fn


def _group():
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A 1-D device mesh: ``devices`` in order along ``axis_name``.

    Under an initialized process group ``devices`` are this rank's entries
    and the global mesh is every rank's, in rank order (``size`` entries):
    ``rank`` and ``world_size`` are read from the group when the mesh is
    made."""

    def __init__(self, devices: Sequence, axis_name: str = "batch"):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devices)
        self.axis_name = axis_name
        self.rank, self.world_size = _group()

    @property
    def size(self) -> int:
        return len(self.devices) * self.world_size

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, {self.axis_name!r}, "
                f"rank {self.rank} of {self.world_size})")


def default_mesh(devices: Optional[Sequence] = None, axis_name: str = "batch") -> Mesh:
    """A 1-D mesh over the given devices, else over every visible card (on
    a process group: this rank's own card, ``cuda:{local_rank %
    device_count}``).  CPU meshes are given explicitly, e.g.
    ``default_mesh([torch.device("cpu")] * 4)``."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA device is visible: pass the mesh's devices, e.g. "
                "default_mesh([torch.device('cpu')] * 4)")
        rank, world = _group()
        if world > 1:
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
            devices = [torch.device("cuda", local_rank % n)]
        else:
            devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(devices, axis_name)


def _check_axis(mesh: Mesh, axis_name: str):
    if mesh.axis_name != axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")


def shard_batch(mesh: Mesh, axis_name: str, *arrays):
    """Split each array's leading batch axis into one contiguous shard a
    (local) mesh entry and place each shard on its device; returns, for
    each array, the tuple of its shards (one array: its tuple alone)."""
    _check_axis(mesh, axis_name)
    n = len(mesh.devices)
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        B = int(a.shape[0])
        if B % n:
            raise ValueError(
                f"a batch of {B} rows does not split evenly over the mesh's "
                f"{n} local entries")
        out.append(tuple(s.to(d) for s, d in zip(a.split(B // n), mesh.devices)))
    return tuple(out) if len(out) > 1 else out[0]


def global_batch_from_local(mesh: Mesh, axis_name: str, *local_arrays):
    """This rank's rows of the global batch, sharded over its own mesh
    entries (``shard_batch``); a sharded solve built under the process
    group takes them as its inputs and returns the global Solution."""
    return shard_batch(mesh, axis_name, *local_arrays)


def distributed_initialize(**kwargs):
    """Join the process group: ``torch.distributed.init_process_group``.

    With no ``backend`` given it takes ``nccl`` where a card is visible
    and ``gloo`` otherwise; ``init_method``, ``world_size`` and ``rank``
    are the caller's (nothing on a machine tells a program of its
    cluster).  A no-op when the group is already initialized; every other
    failure (a bad address, a port conflict) propagates, as in the JAX
    package: a rank that quietly ran alone would surface later as a hang."""
    if dist.is_initialized():
        return
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kwargs)


def _host_staged():
    """gloo has no CUDA all_gather: its collectives run on host copies."""
    return dist.get_backend() == "gloo"


def _all_reduce(t, op):
    staged = _host_staged()
    buf = t.cpu() if staged else t.clone()
    dist.all_reduce(buf, op=op)
    return buf.to(t.device)


def _all_gather_rows(t):
    """Every rank's rows of ``t`` (equal row counts), in rank order."""
    staged = _host_staged()
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = src.cpu() if staged else src.contiguous()
    bufs = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, src)
    out = torch.cat(bufs, dim=0).to(t.device)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def make_sharded_solve_fn(
    spec: ProblemSpec,
    options: Options = Options(),
    mesh: Optional[Mesh] = None,
    callback: Optional[Callable] = None,
    axis_name: str = "batch",
    with_stats: bool = True,
    *,
    dtype=torch.float32,
):
    """Build the batch-sharded solve ``(xs_init [B,...], us_init, ws) ->
    (Solution, BatchStats)`` (the Solution alone without ``with_stats``).

    Each argument is a tensor, split here into one contiguous shard a mesh
    entry (B must divide by the mesh's size, as in the JAX package), or the
    shards ``shard_batch`` returns.  The route follows
    ``make_batched_solve_fn``'s rule (``batch.py::_use_sl``); one solver
    is built a distinct device, in ``dtype``.  The Solution comes back in
    batch order on the mesh's first (local) device.  Under an initialized
    process group the arguments are this rank's rows
    (``global_batch_from_local``), and every rank returns the global
    Solution and stats (module docstring).
    """
    mesh = default_mesh(axis_name=axis_name) if mesh is None else mesh
    _check_axis(mesh, axis_name)
    if mesh.world_size != _group()[1]:
        raise ValueError(f"{mesh} was made for another process group")
    use_sl = _use_sl(options, callback)
    distinct = list(dict.fromkeys(mesh.devices))
    if use_sl:
        from ..core.solve_sl import make_sl_parts

        parts = {d: make_sl_parts(spec, options, device=d, dtype=dtype) for d in distinct}
    else:
        solvers = {d: make_batched_solve_fn(spec, options, callback, device=d, dtype=dtype)
                   for d in distinct}
    n_local = len(mesh.devices)

    def shards_of(i, a):
        """Argument ``i`` as one shard a local mesh entry, each checked."""
        if isinstance(a, torch.Tensor):
            B = int(a.shape[0])
            if B % n_local:
                rows = "this rank's" if mesh.world_size > 1 else "a"
                raise ValueError(
                    f"argument {i}: {rows} batch of {B} lanes does not divide over the "
                    f"mesh's {n_local} (local) entries ({mesh.size} in all)")
            a = [s.to(d) for s, d in zip(a.split(B // n_local), mesh.devices)]
        if len(a) != n_local:
            raise ValueError(f"argument {i}: {len(a)} shards for {n_local} mesh entries")
        for s, d in zip(a, mesh.devices):
            if s.dtype != dtype or s.device != d or s.shape[0] != a[0].shape[0]:
                raise ValueError(
                    f"argument {i}: a shard of {tuple(s.shape)} {s.dtype} on {s.device}; the "
                    f"solve takes equal shards in {dtype} on {[str(d) for d in mesh.devices]}")
        return a

    def solve(xs_init, us_init, ws):
        shards = list(zip(*(shards_of(i, a) for i, a in enumerate((xs_init, us_init, ws)))))
        if use_sl:
            from ..core.solve_sl import run_interleaved, sl_trips

            sols = run_interleaved([sl_trips(parts[d], *args)
                                    for d, args in zip(mesh.devices, shards)])
        else:
            sols = [solvers[d](*args) for d, args in zip(mesh.devices, shards)]
        home = mesh.devices[0]
        sol = Solution(**{f.name: torch.cat([getattr(s, f.name).to(home) for s in sols])
                          for f in dataclasses.fields(Solution)})
        if mesh.world_size > 1:
            n = sol.xs.shape[0]
            rows = _all_reduce(torch.tensor([n, -n], device=home), dist.ReduceOp.MAX)
            if int(rows[0]) != -int(rows[1]):
                raise ValueError(f"the ranks hold from {-int(rows[1])} to {int(rows[0])} "
                                 "rows of the global batch: each must hold as many")
            sol_global = Solution(**{f.name: _all_gather_rows(getattr(sol, f.name))
                                     for f in dataclasses.fields(Solution)})
        else:
            sol_global = sol
        if not with_stats:
            return sol_global
        partial = [_partial_stats(s) for s in sols]
        sums = torch.stack([p[0].to(home) for p in partial]).sum(dim=0)
        vmax = torch.stack([p[1].to(home) for p in partial]).amax(dim=0)
        if mesh.world_size > 1:
            sums = _all_reduce(sums, dist.ReduceOp.SUM)
            vmax = _all_reduce(vmax, dist.ReduceOp.MAX)
        return sol_global, _stats_from(sums, vmax)

    return solve
