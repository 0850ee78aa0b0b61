"""The port's slice end to end (iterativelqr_tpu_torch.make_batched_solve_fn
-> SL solver -> derive/backward -> line search) against the JAX package's SL
solver with its Pallas kernel in interpret mode, on acrobot T=9, B=4 in f64.
Iteration counts, AL iterations and status must be equal exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import acrobot as jax_acrobot
from iterativelqr_tpu.ops.rollout import open_loop_rollout
from iterativelqr_tpu.parallel.batch import (
    make_batched_solve_fn as jax_make_batched_solve_fn,
)
from iterativelqr_tpu_torch import (
    Options,
    batch_stats,
    build_spec,
    make_batched_solve_fn,
)
from iterativelqr_tpu_torch.convert import (
    batch_from_numpy,
    options_from_fields,
    solution_to_numpy,
)
from iterativelqr_tpu_torch.models import acrobot

torch.set_num_threads(1)

T, B = 9, 4
# tests/test_solve_sl.py's _BASE
_BASE = dict(record_traces=False, backward_pass="packed",
             max_iterations=12, max_dual_updates=3)


@pytest.fixture(scope="module")
def inputs():
    jspec = jax_build_spec(*jax_acrobot.problem(T)[:3])
    rng = np.random.default_rng(3)
    x0 = 0.02 * rng.standard_normal((B, 4))
    us = np.full((B, T - 1, 1), 0.05)
    ws = np.zeros((B, T, 0))
    xs = np.asarray(jax.vmap(lambda x, u, w: open_loop_rollout(jspec, x, u, w))(
        jnp.asarray(x0), jnp.asarray(us), jnp.asarray(ws)))
    return jspec, xs, us, ws


@pytest.mark.parametrize("extra", [
    {},
    # the cap fires in the second round with the hotter tuned penalty; the
    # penalty ceiling keeps the Riccati systems conditioned well enough that
    # rounding differences between the frameworks stay below 1e-8 (at the
    # default 1e8 ceiling they reach 1e-4 in xs, with equal iterates)
    dict(early_round_iteration_cap=3, initial_constraint_penalty=1000.0,
         max_penalty=1.0e5),
])
def test_slice_matches_jax_sl_solver(inputs, extra):
    jspec, xs, us, ws = inputs
    jo = JaxOptions(batched_solver="sl", **_BASE, **extra)
    ref = jax_make_batched_solve_fn(jspec, jo, interpret=True)(
        jnp.asarray(xs), jnp.asarray(us), jnp.asarray(ws))

    tspec = build_spec(*acrobot.problem(T)[:3])
    fn = make_batched_solve_fn(
        tspec, options_from_fields(dataclasses.asdict(jo)),
        device="cpu", dtype=torch.float64,
    )
    sol = fn(*batch_from_numpy(xs, us, ws, device="cpu", dtype=torch.float64))
    out = solution_to_numpy(sol)
    for name in ("iterations", "al_iterations", "status"):
        np.testing.assert_array_equal(out[name], np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("xs", "us", "objective", "max_violation"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(ref, name)),
                                   rtol=1e-8, atol=1e-8, err_msg=name)
    for name in ("K", "k", "gradient_norm", "duals", "penalty", "step_size"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    if extra:
        # truncated rounds happened: more iterations than full rounds allow
        assert (out["iterations"] > _BASE["max_iterations"]
                * out["al_iterations"]).any()
    stats = batch_stats(sol)
    assert float(stats.solved_fraction) == float(
        np.mean(out["max_violation"] <= jo.constraint_tolerance))


def test_shared_ws_in_axes_broadcasts(inputs):
    _, xs, us, ws = inputs
    tspec = build_spec(*acrobot.problem(T)[:3])
    opts = Options(batched_solver="sl", **dict(_BASE, max_iterations=3))
    args = batch_from_numpy(xs, us, ws, device="cpu", dtype=torch.float64)
    a = make_batched_solve_fn(tspec, opts, dtype=torch.float64)(*args)
    b = make_batched_solve_fn(tspec, opts, in_axes=(0, 0, None),
                              dtype=torch.float64)(*args[:2], args[2][0])
    assert torch.equal(a.xs, b.xs) and torch.equal(a.iterations, b.iterations)


@pytest.mark.parametrize("kw", [
    dict(),                                   # literal Options(): record_traces
    dict(record_traces=False, batched_solver="vmap"),
    dict(record_traces=False, live_progress=True),
])
def test_vmap_route_is_not_ported(kw):
    tspec = build_spec(*acrobot.problem(T)[:3])
    with pytest.raises(NotImplementedError, match="M10"):
        make_batched_solve_fn(tspec, Options(**kw))


def test_pallas_rollout_kernels_are_not_ported():
    tspec = build_spec(*acrobot.problem(T)[:3])
    with pytest.raises(NotImplementedError, match="K3/K4"):
        make_batched_solve_fn(
            tspec, Options(record_traces=False, forward_kernel="pallas"))


def test_inputs_must_match_device_and_dtype(inputs):
    _, xs, us, ws = inputs
    tspec = build_spec(*acrobot.problem(T)[:3])
    fn = make_batched_solve_fn(tspec, Options(record_traces=False),
                               dtype=torch.float32)
    with pytest.raises(ValueError, match="float64"):
        fn(*batch_from_numpy(xs, us, ws, device="cpu", dtype=torch.float64))


def test_dual_warm_start_and_total_budget_match_jax(inputs):
    """Carried duals/penalties (batched MPC re-solves) with a hard total
    iteration budget, against the JAX SL solver on the same numpy inputs."""
    jspec, xs, us, ws = inputs
    tspec = build_spec(*acrobot.problem(T)[:3])
    cold = make_batched_solve_fn(
        tspec, Options(batched_solver="sl", **_BASE), dtype=torch.float64,
    )(*batch_from_numpy(xs, us, ws, device="cpu", dtype=torch.float64))
    duals0, pen0 = cold.duals.numpy(), cold.penalty.numpy()
    jo = JaxOptions(batched_solver="sl", max_total_iterations=5, **_BASE)
    ref = jax_make_batched_solve_fn(
        jspec, jo, interpret=True, dual_warm_start=True,
    )(*(jnp.asarray(a) for a in (xs, us, ws, duals0, pen0)))
    sol = make_batched_solve_fn(
        tspec, options_from_fields(dataclasses.asdict(jo)),
        dual_warm_start=True, dtype=torch.float64,
    )(*batch_from_numpy(xs, us, ws, duals0, pen0, device="cpu",
                        dtype=torch.float64))
    out = solution_to_numpy(sol)
    assert (out["iterations"] == 5).any()
    for name in ("iterations", "al_iterations", "status"):
        np.testing.assert_array_equal(out[name], np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("xs", "us", "objective", "max_violation", "duals", "penalty"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(ref, name)),
                                   rtol=1e-8, atol=1e-8, err_msg=name)
