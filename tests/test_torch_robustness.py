"""Failure isolation, determinism and random-initialization robustness in
the port (tests/test_robustness.py and tests/test_random_init_robustness.py
on the CPU, f64).

- One pathological lane in a batch (divergence-prone dynamics from an
  exploding initial state) does not poison the others, on the vmap route
  and on the SL route; on the vmap route the good lanes equal the JAX
  package's batched solve of the same inputs within 1e-10.
- The solve is bitwise reproducible call to call (both routes).
- Random controls: acrobot (unit normal, the reference's init) and car
  (0.1 N(0,1)) at T=21 (the reference runs T=51), B=4 lanes drawn from
  numpy seeds, solved at the default options with traces off (the SL
  route), every lane feasible.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativelqr_tpu as jilqr
import iterativelqr_tpu_torch as P
from iterativelqr_tpu.parallel.batch import make_batched_solve_fn as jmake_batched
from iterativelqr_tpu_torch.models import acrobot, car, particle
from iterativelqr_tpu_torch.ops.rollout import open_loop_rollout

torch.set_num_threads(1)

ROUTES = {
    "vmap": dict(verbose=False),
    "sl": dict(verbose=False, record_traces=False, batched_solver="sl",
               backward_pass="packed"),
}


def stiff_problem(pkg, xp, T=11):
    """tests/test_robustness.py's stiff problem: strongly unstable with a
    cubic term, diverging from a large state; the goal (0.3, 0)."""
    stack = (lambda *a: xp.stack(a)) if xp is torch else (lambda *a: xp.array(a))
    dyn = pkg.Dynamics(lambda x, u: stack(x[0] + x[1] + 0.5 * x[0] ** 3, x[1] + u[0]), 2, 1)
    stage = pkg.Cost(lambda x, u: 0.1 * (x @ x + u @ u), 2, 1)
    term = pkg.Cost(lambda x, u: 0.1 * (x @ x), 2, 0)
    target = xp.asarray([0.3, 0.0], dtype=xp.float64)
    goal = pkg.Constraint(lambda x, u: x - target, 2, 0)
    return pkg.build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                          [pkg.Constraint() for _ in range(T - 1)] + [goal])


def _inputs(x0, T, nu):
    B = x0.shape[0]
    xs = np.zeros((B, T, x0.shape[1]))
    xs[:, 0] = x0
    return xs, np.zeros((B, T - 1, nu)), np.zeros((B, T, 0))


@pytest.mark.parametrize("route", list(ROUTES))
def test_bad_instance_does_not_poison_batch(route):
    T = 11
    x0 = np.array([[0.1, 0.0], [0.2, -0.1], [80.0, 50.0], [0.0, 0.2], [-0.2, 0.1],
                   [0.3, 0.0]])
    inputs = _inputs(x0, T, 1)
    sol = P.make_batched_solve_fn(stiff_problem(P, torch), P.Options(**ROUTES[route]),
                                  device="cpu", dtype=torch.float64)(
        *(torch.as_tensor(a) for a in inputs))
    good = [0, 1, 3, 4, 5]
    viol = sol.max_violation.numpy()
    assert np.all(viol[good] <= 5e-3), f"good instances failed: {viol}"
    assert np.all(np.isfinite(sol.xs.numpy()[good]))
    assert np.all(np.isfinite(sol.us.numpy()[good]))
    if route == "vmap":
        jsol = jax.jit(jmake_batched(stiff_problem(jilqr, jnp), jilqr.Options(verbose=False)))(
            *(jnp.asarray(a) for a in inputs))
        np.testing.assert_array_equal(sol.iterations.numpy()[good],
                                      np.asarray(jsol.iterations)[good])
        for f in ("xs", "us"):
            want = np.asarray(getattr(jsol, f))[good]
            np.testing.assert_allclose(getattr(sol, f).numpy()[good], want, rtol=0,
                                       atol=1e-10 * max(np.abs(want).max(), 1.0), err_msg=f)


@pytest.mark.parametrize("route", list(ROUTES))
def test_solve_is_deterministic(route):
    T, B = 11, 8
    spec = P.build_spec(*particle.problem(T, device="cpu")[:3])
    x0 = np.random.default_rng(5).standard_normal((B, 2))
    inputs = [torch.as_tensor(a) for a in _inputs(x0, T, 1)]
    solve = P.make_batched_solve_fn(spec, P.Options(**ROUTES[route]), device="cpu",
                                    dtype=torch.float64)
    a, b = solve(*inputs), solve(*inputs)
    for f in ("xs", "us", "max_violation", "iterations"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _sweep(problem, scale, seed, B=4):
    """B lanes of ``scale`` N(0,1) controls (numpy seed), masked by the
    spec's action mask and rolled out from the model's x1, solved at the
    default options with traces off."""
    dynamics, objective, constraints, x1, _ = problem
    spec = P.build_spec(dynamics, objective, constraints)
    T = spec.T
    rng = np.random.default_rng(seed)
    us = torch.as_tensor(scale * rng.standard_normal((B, T - 1, spec.nu))
                         * np.asarray(spec.u_mask, np.float64))
    ws = torch.zeros((B, T, 0), dtype=torch.float64)
    x0 = torch.zeros(spec.nx, dtype=torch.float64)
    x0[: x1.shape[0]] = x1
    xs = torch.stack([open_loop_rollout(spec, x0, us[b], ws[b]) for b in range(B)])
    sol = P.make_batched_solve_fn(spec, P.Options(verbose=False, record_traces=False),
                                  device="cpu", dtype=torch.float64)(xs, us, ws)
    return P.batch_stats(sol), sol


def test_acrobot_random_controls_all_solve():
    # the reference's own init protocol: unit-scale normal controls
    stats, _ = _sweep(acrobot.problem(21), 1.0, seed=0)
    assert float(stats.solved_fraction) == 1.0, (
        f"solved {float(stats.solved_fraction):.3f}, max viol {float(stats.max_violation):.2e}")


def test_car_random_controls_all_solve():
    # 0.1 N(0,1) car controls are already far rougher than the reference's
    # fixed 0.01 init
    stats, _ = _sweep(car.problem(21), 0.1, seed=1)
    assert float(stats.solved_fraction) == 1.0, (
        f"solved {float(stats.solved_fraction):.3f}, max viol {float(stats.max_violation):.2e}")
