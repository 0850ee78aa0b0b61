"""The planar quadrotor of tests/torch_user_problems.py (RobotZoo.jl's
``PlanarQuadrotor``, (n, m) = (6, 2), RK4, a thrust box and a terminal
goal), written once for both packages: its derivative stacks per t and per
lane against the JAX package's to 1e-12 (the same f64 operations), and its
SL solve on the port's CPU path (the plain versions of the recursion at
(6, 2) and of K3/K4 on its generated device model) against the JAX
package's vmap-route solve of the same inputs, compiled once: equal
iterations on every lane, trajectories and gains within 1e-10 relative to
the largest value (as tests/test_torch_padding.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativelqr_tpu as jilqr
import iterativelqr_tpu_torch as P
from iterativelqr_tpu.parallel.batch import make_batched_solve_fn as jmake_batched
from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk
from test_torch_spec import _jax_eval, _torch_eval
from torch_user_problems import planar_quadrotor, planar_quadrotor_inputs

torch.set_num_threads(1)

ATOL = 1e-12
TOL = 1e-10
T_SOLVE, B_SOLVE = 21, 8
# the hover start of the solve: the goal (2, 1) is out of the thrust box's
# reach from the origin in T_SOLVE steps (1 s), not from here
START = (1.6, 0.8)


@pytest.fixture(scope="module")
def specs():
    return planar_quadrotor(jilqr, jnp, T=11), planar_quadrotor(P, torch, T=11)


@pytest.fixture(scope="module")
def batch():
    """States about the hover with angles up to about 1 rad, thrusts about
    the hover thrust, some outside the box."""
    rng = np.random.default_rng(6)
    B, T = 8, 11
    xs = 0.5 * rng.standard_normal((B, T, 6))
    us = 4.9 + 2.0 * rng.standard_normal((B, T, 2))
    return xs, us, np.zeros((B, T, 0))


def test_layout_matches(specs):
    jspec, tspec = specs
    assert (tspec.nx, tspec.nu, tspec.nc) == (jspec.nx, jspec.nu, jspec.nc) == (6, 2, 6)
    np.testing.assert_array_equal(tspec.ineq_mask, jspec.ineq_mask)
    np.testing.assert_array_equal(tspec.c_mask, jspec.c_mask)


@pytest.mark.parametrize("family", ["dyn_eval", "dyn_jac", "cost_eval", "cost_grad",
                                    "cost_hess", "con_eval", "con_jac"])
def test_stacks_match_jax(specs, batch, family):
    """Every stage type over its own timesteps: fx, fu; gx, gu; gxx, guu,
    gux; cx, cu (and the values), per t and lane, to 1e-12."""
    jspec, tspec = specs
    kind = family.split("_")[0]
    groups = {"dyn": jspec.dyn_groups, "cost": jspec.cost_groups,
              "con": jspec.con_groups}[kind]
    for k, rows in enumerate(groups):
        a = _jax_eval(getattr(jspec, family)[k], rows, *batch)
        b = _torch_eval(getattr(tspec, family)[k], rows, *batch)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_allclose(y, x, rtol=0, atol=ATOL, err_msg=f"{family}[{k}]")


def test_the_kernels_take_a_generated_model(specs):
    """No registered model: the rollout kernels run device functions
    generated from the user's torch functions."""
    model = fk.device_model(specs[1], "cpu")
    assert model is not None and model.generated is not None
    assert (model.generated.nx, model.generated.nu, model.generated.nc_stage) == (6, 2, 4)


@functools.lru_cache(maxsize=None)
def _jax_solution():
    inputs = planar_quadrotor_inputs(B_SOLVE, T_SOLVE, seed=1, start=START)
    fn = jmake_batched(planar_quadrotor(jilqr, jnp, T=T_SOLVE), jilqr.Options(verbose=False))
    jsol = jax.jit(fn)(*(jnp.asarray(a) for a in inputs))
    return {f: np.asarray(getattr(jsol, f)) for f in ("iterations", "xs", "us", "K")}


@pytest.mark.parametrize("forward_kernel", ["pallas", "scan"])
def test_sl_solve_matches_jax(forward_kernel):
    """The SL route, f64, B=8, T=21 from hovers about START, with the
    rollout kernels' plain versions ("pallas") and the loops ("scan"):
    equal iterations lane by lane, xs, us and K within 1e-10 of the JAX
    package's vmap-route solve; every lane feasible."""
    spec = planar_quadrotor(P, torch, T=T_SOLVE)
    opts = P.Options(verbose=False, record_traces=False, batched_solver="sl",
                     forward_kernel=forward_kernel)
    inputs = planar_quadrotor_inputs(B_SOLVE, T_SOLVE, seed=1, start=START)
    sol = P.make_batched_solve_fn(spec, opts, device="cpu", dtype=torch.float64)(
        *(torch.as_tensor(a) for a in inputs))
    want = _jax_solution()
    np.testing.assert_array_equal(sol.iterations.numpy(), want["iterations"])
    for f in ("xs", "us", "K"):
        np.testing.assert_allclose(getattr(sol, f).numpy(), want[f], rtol=0,
                                   atol=TOL * max(np.abs(want[f]).max(), 1.0), err_msg=f)
    assert float(sol.max_violation.max()) <= opts.constraint_tolerance
