"""Horizon-axis (time) sharding of the Riccati recursion for long
trajectories.

Counterpart of ``iterativelqr_tpu/parallel/horizon.py``, whose docstring
derives the decomposition.  The associative scan (``ops/assoc.py``) gives
every stage a value-function element; with the time axis split into n
chunks, one a mesh entry:

1. each chunk's elements run their local reverse prefix composition on the
   chunk's device;
2. the n chunk composites are gathered, in chunk order, to the solve's
   device (in one process, a move from each device);
3. the suffix composites of the later chunks are unrolled there,
   ``S_d = c_{d+1} (x) ... (x) c_{n-1}``, and each chunk's results are
   extended by its ``S_d`` on its device, which is also the value function
   after the chunk's last step;
4. the gains come from the usual Q-expansion over every step at once
   (``ops/assoc.py::_gains``) on the solve's device.

The time axis is padded to a multiple of n with the combine operator's
identity element (``ops/assoc.py::identity_element``), so any (T, n) pair
works.  Mesh entries may repeat a device: one card can hold n chunks.  The
recursion is lane-polymorphic (any leading lane axes), so the solver's
batched form calls it on every lane at once.  A mesh across processes is
refused: the cross-process exchange of composites is not written yet.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..ops.assoc import (_RANKS, _cat, _combine, _gains, _make_element, _reverse_prefix,
                         _slice, identity_element)
from ..ops.batching import custom_vmap
from .shard import Mesh, _check_axis


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


def make_horizon_sharded_backward(mesh: Mesh, axis_name: str = "time"):
    """A backward recursion with the time axis split over the mesh's
    entries: ``backward(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg)`` with
    the signature and returns of ``ops/backward.py::backward_pass_scan``
    (any leading lane axes; ``reg`` a scalar or per lane).  The results
    land on the device of ``gx``."""
    _check_axis(mesh, axis_name)
    if mesh.world_size > 1:
        raise NotImplementedError(
            "time sharding across processes is not written yet: give a mesh of "
            "this process's devices (entries may repeat a device)")
    sharding = time_sharding(mesh, axis_name)
    n = len(mesh.devices)

    def backward(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg):
        dtype, home = gx.dtype, gx.device
        lanes = fx.shape[:-3]
        Tm1, nx = fx.shape[-3], fx.shape[-1]
        T = Tm1 + 1
        um = torch.as_tensor(u_mask, device=home).to(dtype)
        reg = torch.as_tensor(reg, dtype=dtype, device=home).expand(lanes)
        stage, ok_stage = _make_element(fx, fu, gx[..., :-1, :], gu, gxx[..., :-1, :, :],
                                        guu, gux, um, reg)
        zA = torch.zeros_like(gxx[..., -1:, :, :])
        term = (zA, torch.zeros_like(gx[..., -1:, :]), zA, -gx[..., -1:, :],
                gxx[..., -1:, :, :])
        elems = _cat(stage, term)
        # identity elements after the terminal one: no-ops under
        # composition, sliced away below
        Tp = -(-T // n) * n
        ident = identity_element(nx, dtype, home)
        if Tp != T:
            elems = _cat(elems, _lanes_to(ident, lanes, Tp - T))

        # 1. each chunk's local reverse prefix, on its device
        chunks = [(lo, hi, dev) for (lo, hi), dev in zip(sharding.bounds(Tp), sharding.devices)]
        res = [_reverse_prefix(_to(_slice(elems, slice(lo, hi)), dev))
               for lo, hi, dev in chunks]
        # 2. the chunk composites, in chunk order, on the solve's device
        comps = [_to(_slice(r, slice(0, 1)), home) for r in res]
        # 3. suffix composites of the later chunks: S_d = c_{d+1} (x) ...
        acc = _lanes_to(ident, lanes, 1)
        sufs = [acc]
        for i in range(n - 1, 0, -1):
            acc = _combine(comps[i], acc)
            sufs.append(acc)
        sufs.reverse()
        eta_f, J_f, eta_n, J_n = [], [], [], []
        for (lo, hi, dev), r, S in zip(chunks, res, sufs):
            S = _to(S, dev)
            # extend each local result past the chunk's end
            final = _combine(r, tuple(a.expand_as(b) for a, b in zip(S, r)))
            # value function at t+1: shift within the chunk; after the last
            # step comes the next chunk's first result, which is S_d itself
            nxt = _cat(_slice(final, slice(1, None)), S)
            eta_f.append(final[3].to(home))
            J_f.append(final[4].to(home))
            eta_n.append(nxt[3].to(home))
            J_n.append(nxt[4].to(home))
        cat = lambda parts, r: torch.cat(parts, dim=parts[0].ndim - 1 - r)
        p = -cat(eta_f, _RANKS[3])[..., :Tm1, :]          # value gradient at t
        P1 = cat(J_n, _RANKS[4])[..., :Tm1, :, :]         # value Hessian at t+1
        p1 = -cat(eta_n, _RANKS[3])[..., :Tm1, :]
        K, k, Qx, Qu, ok_gain = _gains(fx, fu, gx[..., :-1, :], gu, gxx[..., :-1, :, :],
                                       guu, gux, um, P1, p1, reg)
        ok = (torch.all(ok_stage, dim=-1) & torch.all(ok_gain, dim=-1)
              & torch.all(torch.isfinite(p), dim=(-2, -1))
              & torch.all(torch.isfinite(p1), dim=(-2, -1)))
        return K, k, Qx, Qu, p, ok

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
