"""Time-varying dimensions in the port (tests/test_padding.py's problems):
padded solves equal the JAX package's and keep the padding exact.

1. Actionless steps (num_action=0 on odd steps, the u-mask path) against
   the same problem with inert, penalized actions (their optimum is exactly
   zero): the solutions agree, the masked action rows and gain rows are
   exactly zero.
2. The state dimension changes along the horizon (R2 -> R3 -> R2): the
   solve reaches the terminal goal and the padded state entries stay zero.

Each runs on the vmap route (``Options(verbose=False)``) and on the SL
route with ``backward_pass="packed"`` (K1's plain version on the CPU), B=2
lanes in f64, against the JAX package's batched solve on its vmap route of
the same inputs, compiled once a problem (the JAX package's SL route
reaches the same iterates on these problems; its Pallas kernel in interpret
mode would cost a compile of its own): equal iterations, trajectories and
gains within 1e-10."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativelqr_tpu as jilqr
import iterativelqr_tpu_torch as P
from iterativelqr_tpu.parallel.batch import make_batched_solve_fn as jmake_batched
from torch_user_problems import padded_actionless as actionless
from torch_user_problems import padded_lift_project as lift_project

torch.set_num_threads(1)

ROUTES = {
    "vmap": dict(verbose=False),
    "sl": dict(verbose=False, record_traces=False, batched_solver="sl",
               backward_pass="packed"),
}
TOL = 1e-10


def _inputs(spec, x0):
    """Zero states and controls with ``x0`` [B, d] in each lane's first
    state's leading entries (numpy)."""
    B = x0.shape[0]
    xs = np.zeros((B, spec.T, spec.nx))
    xs[:, 0, : x0.shape[1]] = x0
    return xs, np.zeros((B, spec.T - 1, spec.nu)), np.zeros((B, spec.T, max(spec.npar, 0)))


def _solve(spec, route, inputs, **extra):
    fn = P.make_batched_solve_fn(spec, P.Options(**ROUTES[route], **extra), device="cpu",
                                 dtype=torch.float64)
    return fn(*(torch.as_tensor(a) for a in inputs))


@functools.lru_cache(maxsize=None)
def _jax_solution(problem, x0, extra):
    """The JAX package's vmap-route solve of ``problem`` (a maker of
    tests/torch_user_problems.py) from ``x0`` (nested tuples), as numpy."""
    inputs = _inputs(problem(P, torch), np.array(x0))
    jsol = jax.jit(jmake_batched(problem(jilqr, jnp), jilqr.Options(**ROUTES["vmap"], **dict(extra))))(
        *(jnp.asarray(a) for a in inputs))
    return {f: np.asarray(getattr(jsol, f)) for f in ("iterations", "xs", "us", "K")}


def _check_jax(sol, problem, x0, **extra):
    want = _jax_solution(problem, tuple(map(tuple, x0)), tuple(sorted(extra.items())))
    np.testing.assert_array_equal(sol.iterations.numpy(), want["iterations"])
    for f in ("xs", "us", "K"):
        np.testing.assert_allclose(getattr(sol, f).numpy(), want[f], rtol=0,
                                   atol=TOL * max(np.abs(want[f]).max(), 1.0), err_msg=f)


@pytest.mark.parametrize("route", list(ROUTES))
def test_actionless_steps_match_inert_action_formulation(route):
    het, hom = actionless(P, torch), actionless(P, torch, inert=True)
    assert het.nu == 1 and not bool(het.u_mask[1].any())
    x0 = np.array([[0.0, 0.0], [0.2, -0.1]])
    inputs = _inputs(het, x0)
    sol_het, sol_hom = _solve(het, route, inputs), _solve(hom, route, inputs)
    assert float(sol_het.max_violation.max()) <= 5e-3
    assert float(sol_hom.max_violation.max()) <= 5e-3
    np.testing.assert_allclose(sol_het.xs.numpy(), sol_hom.xs.numpy(), atol=1e-6)
    us_het, us_hom = sol_het.us.numpy(), sol_hom.us.numpy()
    np.testing.assert_allclose(us_het[:, ::2], us_hom[:, ::2], atol=1e-6)
    np.testing.assert_allclose(us_het[:, 1::2], 0.0, atol=1e-12)   # masked rows
    np.testing.assert_allclose(us_hom[:, 1::2], 0.0, atol=1e-6)
    np.testing.assert_array_equal(sol_het.K.numpy()[:, 1::2], 0.0)  # padded gain rows
    _check_jax(sol_het, actionless, x0)


@pytest.mark.parametrize("route", list(ROUTES))
def test_state_dimension_changes_along_horizon(route):
    spec = lift_project(P, torch)
    assert spec.nx == 3 and spec.nu == 2
    assert list(spec.x_dims) == [2, 3, 3, 2] and list(spec.u_dims) == [1, 2, 1]
    x0 = np.array([[0.3, -0.1], [-0.2, 0.4]])
    inputs = _inputs(spec, x0)
    sol = _solve(spec, route, inputs, max_dual_updates=12)
    assert float(sol.max_violation.max()) <= 5e-3
    xs = sol.xs.numpy()
    assert np.all(xs[:, 0, 2] == 0.0) and np.all(xs[:, 3, 2] == 0.0)  # padded entries
    _check_jax(sol, lift_project, x0, max_dual_updates=12)
