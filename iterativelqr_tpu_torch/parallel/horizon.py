"""Horizon-axis (time) sharding of the Riccati recursion for long
trajectories.

Counterpart of ``iterativelqr_tpu/parallel/horizon.py``, whose docstring
derives the decomposition.  The associative scan (``ops/assoc.py``) gives
every stage a value-function element; with the time axis split into n
chunks, one a mesh entry:

1. each chunk's elements run their local reverse prefix composition on the
   chunk's device;
2. the n chunk composites are gathered, in chunk order, to the solve's
   device (in one process, a move from each device; across processes, one
   ``all_gather``);
3. the suffix composites of the later chunks are unrolled there,
   ``S_d = c_{d+1} (x) ... (x) c_{n-1}``, and each chunk's results are
   extended by its ``S_d`` on its device, which is also the value function
   after the chunk's last step;
4. the gains come from the usual Q-expansion over the steps at once
   (``ops/assoc.py::_gains``) on the solve's device: every step in one
   process; across processes each rank's own steps, and a second
   ``all_gather`` gives every rank the global results.

The time axis is padded to a multiple of n with the combine operator's
identity element (``ops/assoc.py::identity_element``), so any (T, n) pair
works.  Mesh entries may repeat a device: one card can hold n chunks.  The
recursion is lane-polymorphic (any leading lane axes), so the solver's
batched form calls it on every lane at once.  Under an initialized
process group every rank calls it with the whole linearization, as every
rank of a per-instance solve holds it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch

from ..ops.assoc import (_RANKS, _cat, _combine, _gains, _make_element, _reverse_prefix,
                         _slice, identity_element)
from ..ops.batching import custom_vmap
from .shard import Mesh, _all_gather_rows, _check_axis, _group


class TimeSharding(NamedTuple):
    """Where each chunk of a [T, ...] stack lives: ``devices`` in chunk
    order (the mesh's)."""

    devices: Sequence[torch.device]

    def bounds(self, length: int):
        """[(lo, hi)] of each chunk: ceil(length / n) steps each, the last
        ones shorter (empty past the end)."""
        n = len(self.devices)
        size = -(-length // n)
        return [(min(d * size, length), min((d + 1) * size, length)) for d in range(n)]

    def place(self, stack: torch.Tensor):
        """The chunks of ``stack`` (time leading), each on its device."""
        return [stack[lo:hi].to(dev) for (lo, hi), dev in
                zip(self.bounds(stack.shape[0]), self.devices)]


def time_sharding(mesh: Mesh, axis_name: str = "time") -> TimeSharding:
    """The chunk bounds and placements of a [T, ...] stack over the mesh's
    entries, as ``make_horizon_sharded_backward`` splits time."""
    _check_axis(mesh, axis_name)
    return TimeSharding(mesh.devices)


def _lanes_to(parts, lanes, length):
    """Unbatched element parts broadcast to ``lanes`` + a time axis."""
    return tuple(a.expand(lanes + (length,) + a.shape) for a in parts)


def _to(parts, device):
    return tuple(a.to(device) for a in parts)


def _time_dim(a, rank):
    """The time axis of a tensor whose trailing ``rank`` axes follow it."""
    return a.ndim - 1 - rank


def _gather_time(a, rank):
    """Every process's ``a`` (equal shapes), concatenated in rank order
    along its time axis (``shard._all_gather_rows``)."""
    d = _time_dim(a, rank)
    return _all_gather_rows(a.movedim(d, 0).contiguous()).movedim(0, d)


def _pad_time(a, rank, length):
    """``a`` zero-padded along its time axis to ``length`` steps."""
    d = _time_dim(a, rank)
    short = length - a.shape[d]
    if short == 0:
        return a
    return torch.cat([a, a.new_zeros(a.shape[:d] + (short,) + a.shape[d + 1:])], dim=d)


def make_horizon_sharded_backward(mesh: Mesh, axis_name: str = "time"):
    """A backward recursion with the time axis split over the mesh's
    entries: ``backward(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg)`` with
    the signature and returns of ``ops/backward.py::backward_pass_scan``
    (any leading lane axes; ``reg`` a scalar or per lane).  The results
    land on the device of ``gx``.

    Under an initialized process group the global mesh is every rank's
    entries in rank order (``Mesh``): each rank is given the whole
    linearization, builds and scans the chunks of its own entries, and one
    ``all_gather`` exchanges the chunk composites (the JAX package's one
    ``all_gather``); each rank then unrolls the suffix composites, extends
    its chunks and expands the gains of its steps, and a second
    ``all_gather`` hands every rank the global ``(K, k, Qx, Qu, p, ok)``,
    as ``parallel/shard.py`` hands every rank the global Solution."""
    _check_axis(mesh, axis_name)
    if mesh.world_size != _group()[1]:
        raise ValueError(f"{mesh} was made for another process group")
    sharding = time_sharding(mesh, axis_name)
    n_local, n, world = len(mesh.devices), mesh.size, mesh.world_size

    def backward(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg):
        dtype, home = gx.dtype, gx.device
        lanes = fx.shape[:-3]
        Tm1, nx = fx.shape[-3], fx.shape[-1]
        T = Tm1 + 1
        um = torch.as_tensor(u_mask, device=home).to(dtype)
        reg = torch.as_tensor(reg, dtype=dtype, device=home).expand(lanes)
        # the padded time axis splits into n chunks of c steps; this rank's
        # chunks cover steps [lo, hi): stage elements below T-1, the
        # terminal one at T-1, identity elements after it (no-ops under
        # composition, sliced away below)
        Tp = -(-T // n) * n
        c = Tp // n
        lo, hi = mesh.rank * n_local * c, (mesh.rank + 1) * n_local * c
        s_hi = max(min(hi, Tm1), lo)      # this rank's stage steps: [lo, s_hi)
        st = slice(lo, s_hi)
        stage, ok_stage = _make_element(fx[..., st, :, :], fu[..., st, :, :], gx[..., st, :],
                                        gu[..., st, :], gxx[..., st, :, :], guu[..., st, :, :],
                                        gux[..., st, :, :], um[st], reg)
        elems = stage
        if lo <= Tm1 < hi:
            zA = torch.zeros_like(gxx[..., -1:, :, :])
            term = (zA, torch.zeros_like(gx[..., -1:, :]), zA, -gx[..., -1:, :],
                    gxx[..., -1:, :, :])
            elems = _cat(elems, term)
        ident = identity_element(nx, dtype, home)
        if hi > max(lo, T):
            elems = _cat(elems, _lanes_to(ident, lanes, hi - max(lo, T)))

        # 1. each chunk's local reverse prefix, on its device
        chunks = [(d * c, (d + 1) * c, dev) for d, dev in enumerate(sharding.devices)]
        res = [_reverse_prefix(_to(_slice(elems, slice(a, b)), dev)) for a, b, dev in chunks]
        # 2. the n chunk composites, in chunk order, on the solve's device
        comps = [_to(_slice(r, slice(0, 1)), home) for r in res]
        if world > 1:
            mine = functools.reduce(_cat, comps)
            every = tuple(_gather_time(a, r) for a, r in zip(mine, _RANKS))
            comps = [_slice(every, slice(d, d + 1)) for d in range(n)]
        # 3. suffix composites of the later chunks: S_d = c_{d+1} (x) ...
        acc = _lanes_to(ident, lanes, 1)
        sufs = [acc]
        for i in range(n - 1, 0, -1):
            acc = _combine(comps[i], acc)
            sufs.append(acc)
        sufs.reverse()
        eta_f, J_n, eta_n = [], [], []
        for (a, b, dev), r, S in zip(chunks, res, sufs[mesh.rank * n_local:]):
            S = _to(S, dev)
            # extend each local result past the chunk's end
            final = _combine(r, tuple(x.expand_as(y) for x, y in zip(S, r)))
            # value function at t+1: shift within the chunk; after the last
            # step comes the next chunk's first result, which is S_d itself
            nxt = _cat(_slice(final, slice(1, None)), S)
            eta_f.append(final[3].to(home))
            J_n.append(nxt[4].to(home))
            eta_n.append(nxt[3].to(home))
        # 4. the gains of this rank's steps
        m = s_hi - lo
        cat = lambda parts, r: torch.cat(parts, dim=parts[0].ndim - 1 - r)
        p = -cat(eta_f, _RANKS[3])[..., :m, :]           # value gradient at t
        P1 = cat(J_n, _RANKS[4])[..., :m, :, :]          # value Hessian at t+1
        p1 = -cat(eta_n, _RANKS[3])[..., :m, :]
        K, k, Qx, Qu, ok_gain = _gains(fx[..., st, :, :], fu[..., st, :, :], gx[..., st, :],
                                       gu[..., st, :], gxx[..., st, :, :], guu[..., st, :, :],
                                       gux[..., st, :, :], um[st], P1, p1, reg)
        ok = (torch.all(ok_stage, dim=-1) & torch.all(ok_gain, dim=-1)
              & torch.all(torch.isfinite(p), dim=(-2, -1))
              & torch.all(torch.isfinite(p1), dim=(-2, -1)))
        if world == 1:
            return K, k, Qx, Qu, p, ok
        # every rank's steps, padded to hi - lo each, in rank order
        outs = [_gather_time(_pad_time(v, r, hi - lo), r)[(Ellipsis, slice(0, Tm1))
                                                          + (slice(None),) * r]
                for v, r in ((K, 2), (k, 1), (Qx, 1), (Qu, 1), (p, 1))]
        ok = _gather_time(ok[..., None], 0).all(dim=-1)
        return (*outs, ok)

    # the solver's batched form calls the recursion on every lane at once
    # (it is lane-polymorphic), not lane by lane
    sharded = custom_vmap(backward)
    sharded.def_vmap(lambda axis_size, in_batched, *args: backward(*args))
    return sharded


def make_long_horizon_solve_fn(
    spec,
    options=None,
    *,
    mesh: Mesh,
    axis_name: str = "time",
    callback=None,
    dual_warm_start: bool = False,
    device="cuda",
):
    """The per-instance constrained solve (``core/solve.py::make_solve_fn``,
    same signature and Solution, ``.vmap`` included) with the Riccati
    recursion's time axis split over ``mesh`` (entries may repeat a
    device).  ``backward_pass`` must not be "packed": that selector is the
    batched pipeline with its own backward kernel."""
    from ..core.options import Options
    from ..core.solve import make_solve_fn

    options = options or Options()
    if options.backward_pass == "packed":
        raise ValueError(
            'make_long_horizon_solve_fn requires backward_pass != "packed" '
            "(the packed pipeline owns its own batched backward kernel)")
    bp = make_horizon_sharded_backward(mesh, axis_name)
    return make_solve_fn(spec, options, callback, dual_warm_start=dual_warm_start,
                         backward_impl=bp, device=device)
