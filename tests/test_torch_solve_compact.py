"""The port's straggler-compaction loop (iterativelqr_tpu_torch/core/
solve_compact.py) against the port's single-shot SL solver: the contract of
tests/test_solve_compact.py, on the CPU in f64, with ``GRAIN`` lowered so
that small batches repack.

Compaction only changes where each lane's iterations run, so every
Solution field equals the single-shot solve's bitwise; the exit gains and
gradient norm may differ on PD-marginal lanes (under 0.5% of entries
beyond 5e-2, as the JAX test allows).  No JAX is needed.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch
from torch.func import vmap

from iterativelqr_tpu_torch import Options, build_spec, make_batched_solve_fn
from iterativelqr_tpu_torch.core import solve_compact
from iterativelqr_tpu_torch.core.solve_compact import make_compacted_solve_fn
from iterativelqr_tpu_torch.core.solve_sl import make_batched_solve_sl
from iterativelqr_tpu_torch.models import car

torch.set_num_threads(1)

T = 8
DT = torch.float64
BASE = dict(record_traces=False, backward_pass="packed", max_iterations=10,
            max_dual_updates=4, batched_solver="sl")
EXACT = ("xs", "us", "objective", "max_violation", "status", "iterations",
         "al_iterations", "step_size", "duals", "penalty", "reg")


def spread_batch(B, scale=0.3, seed=11):
    """Perturbed car swing-in: x0 = x1 + scale N(0,1), controls 0.01,
    states rolled out open loop; iteration counts spread, so the live set
    collapses mid-solve."""
    dyn, cost, con, x1, _ = car.problem(T)
    spec = build_spec(dyn, cost, con)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(x1.numpy() + scale * rng.standard_normal((B, 3)), dtype=DT)
    us = torch.full((B, T - 1, 2), 0.01, dtype=DT)
    xs = [x]
    for t in range(T - 1):
        x = vmap(dyn[t])(x, us[:, t])
        xs.append(x)
    return spec, torch.stack(xs, dim=1), us, torch.zeros((B, T, 0), dtype=DT)


def single_shot(spec, opts, *args, **kw):
    return make_batched_solve_sl(spec, opts, device="cpu", dtype=DT, **kw)(*args)


def compacted(spec, opts, *args, **kw):
    solve = make_compacted_solve_fn(spec, opts, device="cpu", dtype=DT, **kw)
    return solve(*args), solve.last_run


def assert_solutions_equal(out, ref):
    for name in EXACT:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    for name in ("K", "k", "gradient_norm"):
        a, b = getattr(out, name), getattr(ref, name)
        mismatch = (a - b).abs() > 5e-2 + 5e-2 * b.abs()
        assert mismatch.double().mean() < 0.005, name


@pytest.fixture
def grain(monkeypatch):
    """A grain of 8 lanes: a batch of 64 can repack to 32, 16 and 8."""
    monkeypatch.setattr(solve_compact, "GRAIN", 8)


@pytest.mark.parametrize("chunk", [4, 8])
def test_compacted_matches_single_shot_with_repack(grain, chunk):
    B = 64
    spec, xs, us, ws = spread_batch(B)
    opts = Options(**BASE)
    ref = single_shot(spec, opts, xs, us, ws)
    it = ref.iterations
    # a tail: the slowest lane takes over twice the median's iterations
    assert int(it.max()) > 2 * int(it.median())
    out, run = compacted(spec, opts, xs, us, ws, chunk=chunk, rescue=False)
    assert run.repacks >= 1
    assert [b for b, _ in run.shapes][0] == B and run.shapes[-1][0] < B
    assert sum(n for _, n in run.shapes) == int(it.max())
    assert_solutions_equal(out, ref)


def test_compacted_matches_single_shot_no_repack():
    """B below the grain: chunking only, no lane moves."""
    B = 16
    spec, xs, us, ws = spread_batch(B)
    opts = Options(**BASE)
    ref = single_shot(spec, opts, xs, us, ws)
    out, run = compacted(spec, opts, xs, us, ws, chunk=4, rescue=False)
    assert run.repacks == 0 and [b for b, _ in run.shapes] == [B]
    assert_solutions_equal(out, ref)


def test_compacted_dual_warm_start(grain):
    """A warm-started compacted solve equals the warm single-shot solve."""
    B = 64
    spec, xs, us, ws = spread_batch(B)
    opts = Options(**BASE)
    cold = single_shot(spec, opts, xs, us, ws)
    args = (xs, us, ws, cold.duals, cold.penalty)
    ref = single_shot(spec, opts, *args, dual_warm_start=True)
    out, _ = compacted(spec, opts, *args, chunk=3, dual_warm_start=True, rescue=False)
    assert_solutions_equal(out, ref)


def rows_equal(out, rows, ref):
    for name in ("xs", "us", "objective", "max_violation", "iterations", "duals", "penalty"):
        assert torch.equal(getattr(out, name)[rows], getattr(ref, name)[rows]), name


def test_rescue_resolves_capped_failures(grain, caplog):
    """Lanes the truncated schedule leaves infeasible are re-solved at the
    exact uncapped schedule: a weak frozen penalty (0.1, scaling_penalty=1)
    makes feasibility need many dual ascents, tight round tolerances keep
    rounds from ending on their own, and cap=1 with both safety mechanisms
    off never ascends after the first round."""
    B = 16
    spec, xs, us, ws = spread_batch(B, scale=0.1)
    opts = Options(
        record_traces=False, backward_pass="packed", max_iterations=4,
        max_dual_updates=25, batched_solver="sl", scaling_penalty=1.0,
        adaptive_penalty=False, initial_constraint_penalty=0.1,
        objective_tolerance=1e-8, lagrangian_gradient_tolerance=1e-8,
        early_round_iteration_cap=1, max_consecutive_truncations=999,
        truncation_requires_progress=False)
    tol = opts.constraint_tolerance
    bare, _ = compacted(spec, opts, xs, us, ws, chunk=8, rescue=False)
    failed = torch.nonzero(~(bare.max_violation <= tol)).flatten()
    assert failed.numel() >= 1, "scenario no longer exercises the failure mode"
    with caplog.at_level(logging.WARNING, logger=solve_compact.__name__):
        out, run = compacted(spec, opts, xs, us, ws, chunk=8, rescue=True)
    assert bool((out.max_violation <= tol).all())
    assert run.rescued == {"rescue": failed.numel(), "rescue_strong": 0}
    assert any("re-solved at the exact uncapped schedule" in r.message for r in caplog.records)
    ref = single_shot(spec, dataclasses.replace(opts, early_round_iteration_cap=None),
                      xs, us, ws)
    ok = torch.as_tensor(np.setdiff1d(np.arange(B), failed.numpy()))
    rows_equal(out, failed, ref)
    rows_equal(out, ok, bare)


def test_generalized_rescue_resolves_uncapped_failures(grain):
    """Lanes infeasible under any schedule get one re-solve under
    ``rescue_options`` (here a full budget at regularization_initial=1e-3),
    patched from the original inputs; the other rows are untouched."""
    B = 16
    spec, xs, us, ws = spread_batch(B)
    opts = Options(record_traces=False, backward_pass="packed", batched_solver="sl",
                   max_iterations=4, max_dual_updates=2)
    tol = opts.constraint_tolerance
    bare, _ = compacted(spec, opts, xs, us, ws, chunk=8, rescue=False)
    failed = torch.nonzero(~(bare.max_violation <= tol)).flatten()
    assert failed.numel() >= 1, "scenario no longer produces a failed lane"
    ropts = dataclasses.replace(opts, max_iterations=30, max_dual_updates=10,
                                regularization_initial=1e-3)
    out, run = compacted(spec, opts, xs, us, ws, chunk=8, rescue=True, rescue_options=ropts)
    assert bool((out.max_violation <= tol).all())
    assert run.rescued["rescue_strong"] == failed.numel()
    ref = single_shot(spec, ropts, xs, us, ws)
    ok = torch.as_tensor(np.setdiff1d(np.arange(B), failed.numpy()))
    rows_equal(out, failed, ref)
    rows_equal(out, ok, bare)


def test_rescue_detects_nan_lanes(grain, caplog):
    """A lane that overflows to NaN counts as failed (the test is
    ``~(viol <= tol)``) and triggers the strong rescue; the other lanes
    stay solved."""
    B = 16
    spec, xs, us, ws = spread_batch(B)
    opts = Options(**BASE)
    xs = xs.clone()
    xs[3] = xs[3] * 1e300                      # overflow -> NaN lane
    with caplog.at_level(logging.WARNING, logger=solve_compact.__name__):
        out, run = compacted(spec, opts, xs, us, ws, chunk=8)
    assert any("strong rescue" in r.message for r in caplog.records)
    assert run.rescued["rescue_strong"] >= 1
    v = out.max_violation
    assert bool(torch.isnan(v[3])) or float(v[3]) > opts.constraint_tolerance
    others = torch.cat([v[:3], v[4:]])
    assert bool((others <= opts.constraint_tolerance).all())


@pytest.mark.parametrize("n_dev,B", [(2, 64), (3, 64)])
def test_compacted_multi_device_matches_single(grain, n_dev, B):
    """Per-device compaction (tests/test_solve_compact.py::
    test_compacted_multi_device_matches_single): one compaction loop a
    device on contiguous sub-batches, advanced in turns; every lane equals
    the single-device loop's bitwise.  Three devices split B=64 as 21 /
    21 / 22 (np.linspace bounds: B need not divide)."""
    spec, xs, us, ws = spread_batch(B)
    opts = Options(**BASE)
    ref, ref_run = compacted(spec, opts, xs, us, ws, chunk=6)
    out, runs = compacted(spec, opts, xs, us, ws, chunk=6, devices=["cpu"] * n_dev)
    assert len(runs) == n_dev and ref_run.repacks >= 1
    assert [b for b, _ in (r.shapes[0] for r in runs)] == list(
        np.diff(np.linspace(0, B, n_dev + 1).astype(int)))
    assert_solutions_equal(out, ref)


def test_batched_entry_is_the_single_shot_solver():
    """The reference for the checks above is the batched entry point's SL
    route on the same inputs."""
    spec, xs, us, ws = spread_batch(8)
    opts = Options(**BASE)
    ref = make_batched_solve_fn(spec, opts, device="cpu", dtype=DT)(xs, us, ws)
    out = single_shot(spec, opts, xs, us, ws)
    for name in EXACT:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
