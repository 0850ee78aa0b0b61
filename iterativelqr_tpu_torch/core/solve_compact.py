"""Straggler-compaction loop for the batched SL solve.

Counterpart of ``iterativelqr_tpu/core/solve_compact.py``, whose docstring
measures the tail it cuts.  A batched solve loop runs until its slowest
instance stops, so every lane pays for the slowest lane's trips.  This
loop runs the SL solver (``core/solve_sl.py::make_sl_parts``) in chunks
of trips and, between chunks, gathers the still-live lanes into a smaller
batch when they fit in a fraction of the current one:

    carry = init(xs, us, ws)                        # full batch B0
    while live:
        carry = up to `chunk` trips of body(carry)  # stops when all stop
        if round_up(n_live, GRAIN) * shrink <= B_cur:
            fold the carry back into the full-batch carry
            gather live lanes (+ stopped fillers) into the smaller batch
    fold back; solution = finish(full carry)        # one finish, full batch

The SL carry is batch-last (``[..., B]``), so gather and scatter index the
last axis.  Per-lane semantics are those of the single-shot SL solver: a
lane's updates depend on its own values only (stopped lanes are frozen by
the body's ``live`` mask), so where a lane runs changes nothing but the
work.  Then two rescues re-solve failed lanes (``~(viol <= tol)``, so NaN
lanes count) from the ORIGINAL inputs in one grain-sized batch each and
patch their Solution rows: the capped -> uncapped rescue when
``early_round_iteration_cap`` is set, and the strong rescue at escalated
initial regularization.

Each trip tests ``all(stop)`` on the host, as the single-shot solver does.
``GRAIN`` keeps every batch shape a multiple of the kernels' 32-lane blocks
and 16-byte aligned; tests lower it to force repacks at small B.  The JAX
module's program-cache plumbing (``interpret``, ``cache_dir``,
``cache_key``) has no counterpart here.

Per-device compaction (``devices`` with more than one entry, JAX's
``solve_sharded``): the batch splits into one contiguous sub-batch a device
(``np.linspace`` bounds, so any B) and each runs its own compaction loop.
The loops advance trip by trip in turns (``solve_sl.py::run_interleaved``),
so every device has its next trip queued before any device's stop flags
are synced; entries may repeat a device.  Per-lane results are bitwise the
single-device loop's.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .options import Options
from .solve import Solution
from .solve_sl import make_sl_parts, run_interleaved
from .spec import ProblemSpec

# lanes a batch shape is a multiple of (a multiple of 32: the kernels'
# blocks, and of 4 f32 values: 16-byte aligned runs)
GRAIN = 128
_log = logging.getLogger(__name__)


def _round_up(x, mult):
    return -(-x // mult) * mult


@dataclasses.dataclass
class CompactionRecord:
    """What one compacted solve did: the trips at each batch shape it
    visited (in order, a shape visited twice counts twice), the repacks,
    and the lanes each rescue re-solved (a rescue fires at most once)."""

    shapes: list = dataclasses.field(default_factory=list)   # [(B, trips)]
    repacks: int = 0
    rescued: dict = dataclasses.field(
        default_factory=lambda: {"rescue": 0, "rescue_strong": 0})


def _run_to_stop(parts, args):
    """A single-shot solve of ``parts`` on ``args`` (the rescues')."""
    carry, ws = parts.init(*args)
    body = parts.body(ws)
    while not bool(carry.stop.all()):
        carry = body(carry)
    return parts.finish(carry, ws)


def make_compacted_solve_fn(
    spec: ProblemSpec,
    options: Options = Options(),
    *,
    chunk: int = 32,
    shrink: int = 2,
    dual_warm_start: bool = False,
    rescue: bool = True,
    rescue_options: Options | None = None,
    devices=None,
    device="cuda",
    dtype=torch.float32,
):
    """Build ``(xs [B,T,nx], us, ws) -> Solution`` (batch-leading; with
    ``dual_warm_start`` two more tensors ``(duals0, penalty0)`` [B,T,nc]).

    ``chunk``: trips per dispatch before a compaction check (dispatches
    grow at smaller shapes, up to 4 chunks, as in the JAX module).
    ``shrink``: repack only when the live set fits in ``B_cur / shrink``.
    ``rescue``: re-solve failed lanes (module docstring); the rescue parts
    are built at their first use.  ``rescue_options`` replaces the strong
    rescue's default schedule (the options with no iteration cap and
    ``regularization_initial = max(reg_init, 1e-3)``).  The solve runs on
    ``device`` in ``dtype`` (the card unless the caller passes "cpu");
    ``devices`` with more than one entry runs one compaction loop a device
    (module docstring), with the inputs and the Solution on ``device``.
    The returned callable's ``last_run`` is the ``CompactionRecord`` of its
    latest call (with ``devices``, a list of them, one a sub-batch).

    Exit diagnostics: trajectories, iterates, duals and violations equal
    the single-shot SL solver's bitwise; ``K``, ``k`` and
    ``gradient_norm`` come from one finish on the full batch and may
    differ on PD-marginal lanes, as in the JAX module.
    """
    device = torch.device(device)
    rescue_schedules = []
    if rescue:
        if options.early_round_iteration_cap is not None:
            # the exact uncapped schedule: rescued rows are bitwise the
            # uncapped single-shot solver's
            rescue_schedules.append(
                ("rescue", dataclasses.replace(options, early_round_iteration_cap=None)))
        rescue_schedules.append(("rescue_strong", rescue_options or dataclasses.replace(
            options, early_round_iteration_cap=None,
            regularization_initial=max(options.regularization_initial, 1.0e-3))))
    built = {}
    tol = options.constraint_tolerance

    def parts_on(dev, tag="solve", opts=options):
        """The SL parts of one schedule on one device, built at first use."""
        if (tag, dev) not in built:
            built[tag, dev] = make_sl_parts(spec, opts, device=dev, dtype=dtype,
                                            dual_warm_start=dual_warm_start)
        return built[tag, dev]

    def gather(tree, idx):
        return type(tree)(*(a.index_select(-1, idx) for a in tree))

    def scatter(full, small, idx):
        return type(full)(*(f.index_copy(-1, idx, s) for f, s in zip(full, small)))

    def run_rescue(sol, failed, inputs, dev, tag, opts_r):
        """Re-solve the lanes ``failed`` from their original inputs under
        ``opts_r`` in one grain-sized batch (tiled to fill; the replicas
        are discarded) and patch their rows of ``sol``."""
        Br = max(GRAIN, _round_up(failed.size, GRAIN))
        sel = torch.as_tensor(np.resize(failed, Br), device=dev)
        sol_r = _run_to_stop(parts_on(dev, tag, opts_r),
                             tuple(a.index_select(0, sel) for a in inputs))
        rows = torch.as_tensor(failed, device=dev)
        n = failed.size
        return Solution(**{
            f.name: getattr(sol, f.name).index_copy(0, rows, getattr(sol_r, f.name)[:n])
            for f in dataclasses.fields(sol)})

    def compact(inputs, dev, record):
        """One compaction loop on ``dev`` (where ``inputs`` are), as a
        generator that yields after queueing each trip and returns the
        Solution."""
        parts = parts_on(dev)
        carry_full, ws_full = parts.init(*inputs)
        B0 = carry_full.stop.shape[-1]
        carry, ws_cur, idx = carry_full, ws_full, None
        while True:
            Bc = carry.stop.shape[-1]
            body = parts.body(ws_cur)
            trips = 0
            for _ in range(min(chunk * max(B0 // Bc, 1), 4 * chunk)):
                if bool(carry.stop.all()):
                    break
                carry = body(carry)
                trips += 1
                yield
            if record.shapes and record.shapes[-1][0] == Bc:
                record.shapes[-1] = (Bc, record.shapes[-1][1] + trips)
            else:
                record.shapes.append((Bc, trips))
            if idx is None:
                carry_full = carry
            stop = carry.stop.cpu().numpy()
            if stop.all():
                break
            live = np.flatnonzero(~stop)
            B_next = max(GRAIN, _round_up(live.size, GRAIN))
            if B_next * shrink > Bc:
                continue
            # repack: live lanes + stopped fillers to B_next
            sel = np.concatenate([live, np.flatnonzero(stop)[: B_next - live.size]])
            if idx is not None:
                carry_full = scatter(carry_full, carry, idx)
                sel = idx.cpu().numpy()[sel]          # to full-batch lanes
            idx = torch.as_tensor(sel, device=dev)
            carry, ws_cur = gather(carry_full, idx), ws_full.index_select(-1, idx)
            record.repacks += 1
        if idx is not None:
            carry_full = scatter(carry_full, carry, idx)
        sol = parts.finish(carry_full, ws_full)
        for tag, opts_r in rescue_schedules:
            # ~(viol <= tol): NaN lanes count as failed
            failed = np.flatnonzero(~(sol.max_violation.cpu().numpy() <= tol))
            if failed.size:
                record.rescued[tag] = int(failed.size)
                sol = run_rescue(sol, failed, inputs, dev, tag, opts_r)
        return sol

    def log_rescues(records):
        """One warning a rescue kind, summed over the sub-batches."""
        lanes = sum(r.rescued["rescue"] for r in records)
        if lanes:
            _log.warning(
                "[compact] rescue: %d lane(s) exited infeasible under the "
                "truncated schedule; re-solved at the exact uncapped schedule", lanes)
        lanes = sum(r.rescued["rescue_strong"] for r in records)
        if lanes:
            _log.warning(
                "[compact] strong rescue: %d lane(s) infeasible/NaN even "
                "uncapped; re-solved at escalated initial regularization (%g)",
                lanes, rescue_schedules[-1][1].regularization_initial)

    parts_on(device)     # checks the rollout-kernel choice now

    def solve(xs_b, us_b, ws_b, *warm) -> Solution:
        inputs = (xs_b, us_b, ws_b) + warm
        for i, a in enumerate(inputs):
            if a.dtype != dtype or a.device.type != device.type:
                raise ValueError(f"argument {i}: {a.dtype} on {a.device}, but the "
                                 f"solver was built for {dtype} on {device}")
        if devices is None or len(devices) <= 1:
            record = CompactionRecord()
            solve.last_run = record
            (sol,) = run_interleaved([compact(inputs, device, record)])
            log_rescues([record])
            return sol
        # per-device compaction: contiguous sub-batches, np.linspace bounds
        bounds = np.linspace(0, int(xs_b.shape[0]), len(devices) + 1).astype(int)
        subs = [(torch.device(d), int(lo), int(hi))
                for d, lo, hi in zip(devices, bounds[:-1], bounds[1:]) if hi > lo]
        records = [CompactionRecord() for _ in subs]
        solve.last_run = records
        sols = run_interleaved([
            compact(tuple(a[lo:hi].to(dev) for a in inputs), dev, rec)
            for (dev, lo, hi), rec in zip(subs, records)])
        log_rescues(records)
        return Solution(**{
            f.name: torch.cat([getattr(s, f.name).to(device) for s in sols], dim=0)
            for f in dataclasses.fields(Solution)})

    solve.last_run = None
    return solve
