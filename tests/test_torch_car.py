"""The port's car model (iterativelqr_tpu_torch/models/car.py) against the
JAX package's: stage functions and derivative stacks per t and per lane to
1e-12 (same f64 operations), and the SL batched solve with the loop
rollouts (forward_kernel="scan") at T=8, B=4: equal iterations, AL
iterations and status."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import car as jax_car
from iterativelqr_tpu.ops.derivatives import constraint_values as jax_cv
from iterativelqr_tpu.parallel.batch import (
    make_batched_solve_fn as jax_make_batched_solve_fn,
)
from iterativelqr_tpu_torch import build_spec, make_batched_solve_fn
from iterativelqr_tpu_torch.convert import (
    batch_from_numpy,
    options_from_fields,
    solution_to_numpy,
)
from iterativelqr_tpu_torch.models import car
from iterativelqr_tpu_torch.ops.derivatives import constraint_values
from test_torch_sl_forward_kernel import _BASE, inputs
from test_torch_spec import _cmp, _jax_eval, _torch_eval

torch.set_num_threads(1)

T, B = 11, 8
ATOL = 1e-12


@pytest.fixture(scope="module")
def specs():
    return (jax_build_spec(*jax_car.problem(T)[:3]),
            build_spec(*car.problem(T)[:3]))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((B, T, 3))
    us = 4.0 * rng.standard_normal((B, T, 2))   # some past the +-5 bounds
    us[:, -1] = 0.0
    ws = np.zeros((B, T, 0))
    return xs, us, ws


def test_spec_layout_matches(specs):
    jspec, tspec = specs
    for name in ("T", "nx", "nu", "nc", "npar"):
        assert getattr(tspec, name) == getattr(jspec, name)
    for name in ("dyn_tidx", "cost_tidx", "con_tidx", "c_dims", "c_mask",
                 "ineq_mask"):
        np.testing.assert_array_equal(getattr(tspec, name), getattr(jspec, name))


@pytest.mark.parametrize("family", [
    "dyn_eval", "dyn_jac", "cost_eval", "cost_grad", "cost_hess",
    "con_eval", "con_jac",
])
def test_stage_functions_match_per_t_and_lane(specs, batch, family):
    jspec, tspec = specs
    xs, us, ws = batch
    groups = {"dyn": jspec.dyn_groups, "cost": jspec.cost_groups,
              "con": jspec.con_groups}[family.split("_")[0]]
    for k, rows in enumerate(groups):
        _cmp(_jax_eval(getattr(jspec, family)[k], rows, xs, us, ws),
             _torch_eval(getattr(tspec, family)[k], rows, xs, us, ws))


def test_constraint_values_match(specs, batch):
    jspec, tspec = specs
    xs, us, ws = batch
    a = np.asarray(jax.vmap(lambda x, u, w: jax_cv(jspec, x, u, w))(
        jnp.asarray(xs), jnp.asarray(us[:, :-1]), jnp.asarray(ws)))
    t = lambda v: torch.as_tensor(v, dtype=torch.float64)
    b = torch.func.vmap(lambda x, u, w: constraint_values(tspec, x, u, w))(
        t(xs), t(us[:, :-1]), t(ws)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
    assert (a > 0).any() and (a < 0).any()


def test_problem_parameters_and_initial_controls():
    """Non-default parameters reach every stage function; the reference's
    initial controls."""
    kw = dict(x_goal=(2.0, 0.5, 0.1), u_lower=-3.0, u_upper=4.0,
              obstacle_center=(0.2, 0.7), obstacle_radius=0.3)
    jspec = jax_build_spec(*jax_car.problem(6, **kw)[:3])
    tspec = build_spec(*car.problem(6, **kw)[:3])
    x = np.array([0.4, 0.6, 0.2])
    u = np.array([4.5, -3.5])
    w = np.zeros(0)
    for fam in ("cost_eval", "con_eval"):
        for k in range(len(getattr(jspec, fam))):
            a = np.asarray(getattr(jspec, fam)[k](jnp.asarray(x), jnp.asarray(u),
                                                  jnp.asarray(w)))
            b = getattr(tspec, fam)[k](torch.as_tensor(x), torch.as_tensor(u),
                                       torch.as_tensor(w)).numpy()
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        np.stack([np.asarray(v) for v in jax_car.initial_controls(6)]),
        torch.stack(car.initial_controls(6)).numpy())


def test_car_solve_with_loops_matches_jax():
    Tc = 8
    jspec = jax_build_spec(*jax_car.problem(Tc)[:3])
    tspec = build_spec(*car.problem(Tc)[:3])
    xs, us, ws = inputs(jspec, Tc, 4, 0.01, seed=5)
    jo = JaxOptions(forward_kernel="scan", **_BASE)
    ref = jax_make_batched_solve_fn(jspec, jo, interpret=True)(
        jnp.asarray(xs), jnp.asarray(us), jnp.asarray(ws))
    sol = make_batched_solve_fn(
        tspec, options_from_fields(dataclasses.asdict(jo)),
        device="cpu", dtype=torch.float64,
    )(*batch_from_numpy(xs, us, ws, device="cpu", dtype=torch.float64))
    out = solution_to_numpy(sol)
    for f in ("iterations", "al_iterations", "status"):
        np.testing.assert_array_equal(out[f], np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ("xs", "us", "objective", "duals"):
        np.testing.assert_allclose(out[f], np.asarray(getattr(ref, f)),
                                   rtol=1e-10, atol=1e-10, err_msg=f)
