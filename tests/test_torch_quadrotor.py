"""The port's quadrotor model (iterativelqr_tpu_torch/models/quadrotor.py)
against the JAX package's: stage functions and derivative stacks per t and
per lane to 1e-12 (same f64 operations), constraint values, parameters,
hover controls, the rollout kernels' registry, and the SL batched solve
with the loop rollouts (forward_kernel="scan") at T=8, B=4: equal
iterations, AL iterations and status."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import quadrotor as jax_quadrotor
from iterativelqr_tpu.ops.derivatives import constraint_values as jax_cv
from iterativelqr_tpu.ops.rollout import open_loop_rollout
from iterativelqr_tpu.parallel.batch import (
    make_batched_solve_fn as jax_make_batched_solve_fn,
)
from iterativelqr_tpu_torch import Cost, build_spec, make_batched_solve_fn
from iterativelqr_tpu_torch.convert import (
    batch_from_numpy,
    options_from_fields,
    solution_to_numpy,
)
from iterativelqr_tpu_torch.models import quadrotor
from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk
from iterativelqr_tpu_torch.ops.derivatives import constraint_values
from test_torch_sl_forward_kernel import _BASE
from test_torch_spec import _cmp, _jax_eval, _torch_eval

torch.set_num_threads(1)

T, B = 11, 8
ATOL = 1e-12


@pytest.fixture(scope="module")
def specs():
    return (jax_build_spec(*jax_quadrotor.problem(T)[:3]),
            build_spec(*quadrotor.problem(T)[:3]))


@pytest.fixture(scope="module")
def batch():
    """States with angles up to about 0.6 rad (tan and 1/cos of pitch stay
    tame) and thrusts around hover, some past the [0, 6] bounds."""
    rng = np.random.default_rng(4)
    xs = 0.3 * rng.standard_normal((B, T, 12))
    us = quadrotor.HOVER + 2.5 * rng.standard_normal((B, T, 4))
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
    assert (tspec.nx, tspec.nu, tspec.nc) == (12, 4, 12)


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
    assert (a[:, :-1, :8] > 0).any() and (a[:, :-1, :8] < 0).any()


def test_problem_parameters_and_hover_controls():
    """Non-default parameters reach every stage function; the hover
    controls and the terminal state."""
    kw = dict(goal=(2.0, -0.5, 1.5), u_min=0.5, u_max=5.0)
    jd, jc, jk, jx1, jxT = jax_quadrotor.problem(6, **kw)
    td, tc, tk, tx1, txT = quadrotor.problem(6, **kw)
    jspec, tspec = jax_build_spec(jd, jc, jk), build_spec(td, tc, tk)
    rng = np.random.default_rng(1)
    x = 0.4 * rng.standard_normal(12)
    u = np.array([0.2, 5.5, 2.0, 3.0])
    w = np.zeros(0)
    for fam in ("cost_eval", "con_eval"):
        for k in range(len(getattr(jspec, fam))):
            a = np.asarray(getattr(jspec, fam)[k](jnp.asarray(x), jnp.asarray(u),
                                                  jnp.asarray(w)))
            b = getattr(tspec, fam)[k](torch.as_tensor(x), torch.as_tensor(u),
                                       torch.as_tensor(w)).numpy()
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(txT.numpy(), np.asarray(jxT))
    np.testing.assert_array_equal(tx1.numpy(), np.asarray(jx1))
    np.testing.assert_array_equal(
        np.stack([np.asarray(v) for v in jax_quadrotor.hover_controls(6)]),
        torch.stack(quadrotor.hover_controls(6)).numpy())


def test_device_model_registry():
    """The quadrotor's own functions, bound to one problem's parameters,
    are recognised with those parameters; another cost is not the
    registry's quadrotor (a model generated from the functions serves
    it)."""
    m = fk.device_model(build_spec(*quadrotor.problem(9)[:3]))
    assert m == fk.DeviceModel(
        "quadrotor", (1.0, 1.0, 1.0) + (0.0,) * 4 + (6.0,) * 4)
    moved = fk.device_model(build_spec(*quadrotor.problem(
        9, goal=(0.0, 2.0, 3.0), u_min=(0.1, 0.2, 0.3, 0.4), u_max=7.0)[:3]))
    assert moved.params == (0.0, 2.0, 3.0, 0.1, 0.2, 0.3, 0.4) + (7.0,) * 4
    assert len(moved.params) <= fk._MAX_PARAMS
    dyn, cost, con, *_ = quadrotor.problem(9)
    mine = Cost(lambda x, u: 0.05 * torch.dot(u, u), 12, 4)
    other = fk.device_model(build_spec(dyn, [mine] * 8 + cost[-1:], con))
    assert other.generated is not None and other.name.startswith("gen_")


def test_quadrotor_solve_with_loops_matches_jax():
    Tc, Bc = 8, 4
    jspec = jax_build_spec(*jax_quadrotor.problem(Tc)[:3])
    tspec = build_spec(*quadrotor.problem(Tc)[:3])
    # measure_all.py's protocol: x0 = 0.05 N(0,1) on all states, hover
    # controls, states rolled out open loop
    rng = np.random.default_rng(5)
    x0 = 0.05 * rng.standard_normal((Bc, 12))
    us = np.broadcast_to(
        np.stack([np.asarray(u) for u in jax_quadrotor.hover_controls(Tc)]),
        (Bc, Tc - 1, 4)).copy()
    ws = np.zeros((Bc, Tc, 0))
    xs = np.asarray(jax.vmap(lambda x, u, w: open_loop_rollout(jspec, x, u, w))(
        jnp.asarray(x0), jnp.asarray(us), jnp.asarray(ws)))
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
