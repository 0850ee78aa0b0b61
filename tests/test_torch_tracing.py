"""The port's spans, counters and solve log (iterativelqr_tpu_torch/utils/
profiling.py) on the SL route, on the CPU: the car at B=8, T=11.

With a profiler recording, one solve records its span tree: ``init``, each
trip's ``sync.stop`` and ``trip`` (whose children ``derive``, ``augment``,
``backward``, ``slope``, ``line_search`` and ``al_update`` partition it),
the last ``sync.stop`` and ``finish`` (with its own ``derive``,
``augment``, ``backward`` and ``slope``).  With none, a span calls nothing
of the profiler, NVTX or CUDA events and records nothing.  The sync-site
counters follow the loops' structure, and the solve log holds one entry
for each finished solve.  No JAX is needed.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import vmap

from iterativelqr_tpu_torch import Options, build_spec
from iterativelqr_tpu_torch.core.solve_sl import make_batched_solve_sl, make_sl_parts, sl_trips
from iterativelqr_tpu_torch.models import car
from iterativelqr_tpu_torch.ops import packed_backward as pk
from iterativelqr_tpu_torch.utils import profiling

torch.set_num_threads(1)

T, B = 11, 8
DT = torch.float64
OPTS = Options(record_traces=False, max_total_iterations=3)
PHASES = ["derive", "augment", "backward", "slope", "line_search", "al_update"]


def car_batch(scale=0.02, seed=0):
    """Perturbed starts about the car's x1, controls 0.01, states rolled out."""
    dyn, cost, con, x1, _ = car.problem(T)
    spec = build_spec(dyn, cost, con)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(x1.numpy() + scale * rng.standard_normal((B, 3)), dtype=DT)
    us = torch.full((B, T - 1, 2), 0.01, dtype=DT)
    xs = [x]
    for t in range(T - 1):
        x = vmap(dyn[t])(x, us[:, t])
        xs.append(x)
    return spec, (torch.stack(xs, dim=1), us, torch.zeros((B, T, 0), dtype=DT))


def solve(spec, opts, args):
    return make_batched_solve_sl(spec, opts, device="cpu", dtype=DT)(*args)


@contextlib.contextmanager
def profiler():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield prof


def children(recs, parent):
    return [r for r in recs if r["parent"] == parent["id"]]


def test_one_solve_records_its_span_tree():
    spec, args = car_batch()
    profiling.drain()
    with profiler() as prof:
        sol = solve(spec, OPTS, args)
    recs = profiling.drain()
    trips = int(sol.iterations.max())
    assert trips == 3
    (sid,) = {r["solve"] for r in recs}
    top = [r for r in recs if r["parent"] == sid]
    assert [r["name"] for r in top] == (["init"] + ["sync.stop", "trip"] * trips
                                        + ["sync.stop", "finish"])
    assert [r["trip"] for r in top if r["name"] == "trip"] == list(range(trips))
    assert [r["trip"] for r in top if r["name"] == "sync.stop"] == list(range(trips + 1))
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["parent"] != sid:
            p = by_id[r["parent"]]
            # a child lies inside its parent and carries its trip
            assert p["host_start_ns"] <= r["host_start_ns"] <= r["host_end_ns"] <= p["host_end_ns"]
            assert r["trip"] == p["trip"]
        assert r["device_ms"] is None                       # no card
    for trip in (r for r in top if r["name"] == "trip"):
        kids = children(recs, trip)
        assert [r["name"] for r in kids] == PHASES
        (bw,) = [r for r in kids if r["name"] == "backward"]
        assert {r["name"] for r in children(recs, bw)} == {"sync.retry"}
        (ls,) = [r for r in kids if r["name"] == "line_search"]
        assert [r["name"] for r in children(recs, ls)] == ["sync.tail"]
        assert not children(recs, kids[0]) and not children(recs, kids[-1])
    (fin,) = [r for r in top if r["name"] == "finish"]
    assert [r["name"] for r in children(recs, fin)] == PHASES[:4]
    assert fin["trip"] is None
    # the profiler's own event list holds every span as ilqr.<name>
    seen = [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(profiling.PREFIX)]
    assert sorted(seen) == sorted(profiling.PREFIX + r["name"] for r in recs)


def test_spans_touch_nothing_without_a_profiler(monkeypatch):
    spec, args = car_batch()
    calls = {"record_function": 0, "nvtx": 0, "event": 0}

    def counting(key):
        def fn(*a, **kw):
            calls[key] += 1
            return contextlib.nullcontext()
        return fn

    monkeypatch.setattr(torch.profiler, "record_function", counting("record_function"))
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting("record_function"))
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", counting("nvtx"))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", counting("nvtx"))
    monkeypatch.setattr(torch.cuda, "Event", counting("event"))
    profiling.drain()
    before = profiling.counters()
    sol = solve(spec, OPTS, args)
    assert calls == {"record_function": 0, "nvtx": 0, "event": 0}
    assert profiling.drain() == []
    # the counters stay on
    trips = int(sol.iterations.max())
    assert profiling.counters()["sync.stop"] - before["sync.stop"] == trips + 1
    # and the same spans call the profiler while one records
    with profiler():
        solve(spec, OPTS, args)
    assert calls["record_function"] > 0
    assert len(profiling.drain()) == calls["record_function"]


def retry_forced(monkeypatch):
    """The recursion reports lane 0 not positive definite on every other
    attempt, the first of each backward pass: every pass takes two."""
    plain, n = pk.backward_pass_multiref, [0]

    def flaky(*a):
        outs = plain(*a)
        n[0] += 1
        if n[0] % 2:
            outs[-1][0] = 0.0
        return outs

    monkeypatch.setattr(pk, "backward_pass_multiref", flaky)


@pytest.mark.parametrize("case", ["plain", "retry", "out_of_steps", "head_only"])
def test_sync_sites_count_the_loops(case, monkeypatch):
    """``sync.stop`` = trips + 1; ``sync.retry`` = the attempts + 1 of every
    backward pass (the trips' and finish's), one fewer where the retry ran
    out of steps; ``sync.tail`` = trips when more than 8 candidates."""
    spec, args = car_batch()
    opts = OPTS
    if case == "retry":
        retry_forced(monkeypatch)
    if case == "out_of_steps":
        opts = dataclasses.replace(opts, max_regularization_steps=0)
    if case == "head_only":
        opts = dataclasses.replace(opts, max_line_search_iterations=8)
    attempts = []
    plain = pk.backward_pass_multiref

    def counted(*a):
        attempts.append(1)
        return plain(*a)

    monkeypatch.setattr(pk, "backward_pass_multiref", counted)
    profiling.drain()
    before = profiling.counters()
    with profiler():
        sol = solve(spec, opts, args)
    recs = profiling.drain()
    got = {k: profiling.counters()[k] - before[k] for k in profiling.SYNC_SITES}
    trips = int(sol.iterations.max())
    # the backward passes, from the spans: the trips' and finish's
    passes = [r for r in recs if r["name"] == "backward"]
    assert len(passes) == trips + 1
    per_pass = {"plain": 1, "retry": 2, "out_of_steps": 1, "head_only": 1}[case]
    assert len(attempts) == per_pass * len(passes)
    out_of_steps = per_pass == opts.max_regularization_steps + 1
    assert got["sync.stop"] == trips + 1
    assert got["sync.retry"] == len(passes) * (per_pass + 1 - out_of_steps)
    assert got["sync.tail"] == (trips if opts.num_step_sizes > 8 else 0)
    assert sum(1 for r in recs if r["name"] == "sync.retry") == got["sync.retry"]


def test_solve_log_holds_each_finished_solve():
    spec, args = car_batch(scale=0.3, seed=11)
    opts = dataclasses.replace(OPTS, max_total_iterations=None, max_iterations=6,
                               max_dual_updates=3)
    n0 = len(profiling.solve_log())
    sol = solve(spec, opts, args)
    log = profiling.solve_log()
    assert len(log) == min(n0 + 1, profiling.MAX_SOLVES)
    entry = log[-1]
    its = sol.iterations
    assert its.min() < its.max()            # lanes stop on different trips
    assert entry["lanes"] == B and entry["trips"] == int(its.max())
    assert entry["live_lane_trips"] == int(its.sum())
    # a solve closed before its finish adds none
    gen = sl_trips(make_sl_parts(spec, opts, device="cpu", dtype=DT), *args)
    next(gen)
    next(gen)
    gen.close()
    assert len(profiling.solve_log()) == len(log)
    assert profiling.solve_log()[-1] == entry
