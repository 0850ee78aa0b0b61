"""The port's SL solve of user problems with generated device models
(forward_kernel="pallas"; on the CPU the rollout wrappers run their plain
versions) against the JAX package's SL solve with its Pallas K3/K4 in
interpret mode, in f64: examples/mpc_farm.py's problem (tracking lambdas
around a closed-over goal) and examples/sensitivity_demo.py's (a target
path in the per-step parameters w, a different ramp on every lane), T=8,
B=4.  As tests/test_torch_sl_forward_kernel.py: equal iterations, AL
iterations and status per lane; trajectories, duals and violations within
1e-10 of the field's largest magnitude, the objective within 1e-9."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_user_problems import demo_problem, farm_problem

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.core.spec import Constraint as JConstraint
from iterativelqr_tpu.core.spec import Cost as JCost
from iterativelqr_tpu.core.spec import Dynamics as JDynamics
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import particle as jax_particle
from iterativelqr_tpu.ops.rollout import open_loop_rollout
from iterativelqr_tpu.parallel.batch import make_batched_solve_fn as jax_make_batched_solve_fn
from iterativelqr_tpu_torch import make_batched_solve_fn
from iterativelqr_tpu_torch.convert import batch_from_numpy, options_from_fields, solution_to_numpy
from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk

torch.set_num_threads(1)

TOL = 1e-10
TOL_OBJECTIVE = 1e-9
_BASE = dict(record_traces=False, backward_pass="packed", batched_solver="sl",
             max_iterations=12, max_dual_updates=3, forward_kernel="pallas")


def jax_farm(T):
    """examples/mpc_farm.py's problem, as the example builds it."""
    xT = jnp.array([1.0, 0.0])
    dyn = JDynamics(jax_particle.particle_discrete, 2, 1)
    stage = JCost(lambda x, u: 0.5 * jnp.sum((x - xT) ** 2) + 0.1 * jnp.sum(u**2), 2, 1)
    term = JCost(lambda x, u: 0.5 * jnp.sum((x - xT) ** 2), 2, 0)
    goal = JConstraint(lambda x, u: x - xT, 2, 0)
    return jax_build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                          [JConstraint() for _ in range(T - 1)] + [goal])


def jax_demo(T):
    """examples/sensitivity_demo.py's problem, as the example builds it."""
    A = jnp.array([[1.0, 0.2], [0.0, 1.0]])
    B = jnp.array([0.0, 0.2])
    dyn = JDynamics(lambda x, u, w: A @ x + B * u[0], 2, 1, num_parameter=2)
    stage = JCost(lambda x, u, w: 0.5 * jnp.sum((x - w) ** 2) + 0.05 * jnp.sum(u**2),
                  2, 1, num_parameter=2)
    term = JCost(lambda x, u, w: 0.5 * jnp.sum((x - w) ** 2), 2, 0, num_parameter=2)
    goal = JConstraint(lambda x, u, w: x - w, 2, 0, num_parameter=2)
    return jax_build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                          [JConstraint() for _ in range(T - 1)] + [goal])


_PROBLEMS = {"farm": (jax_farm, farm_problem), "demo": (jax_demo, demo_problem)}


def inputs(jspec, T, B, seed):
    """x0 = 0.3 N(0,1), zero controls, states rolled out by the JAX spec;
    for a spec with parameters, a target ramp to (s, c) with s and c
    drawn for each lane (numpy out)."""
    rng = np.random.default_rng(seed)
    x0 = 0.3 * rng.standard_normal((B, jspec.nx))
    us = np.zeros((B, T - 1, jspec.nu))
    ws = np.zeros((B, T, jspec.npar))
    if jspec.npar:
        ramp = np.linspace(0.0, 1.0, T)[None, :]
        ws[:, :, 0] = ramp * rng.uniform(0.5, 1.5, (B, 1))
        ws[:, :, 1] = rng.uniform(-0.3, 0.3, (B, 1))
    xs = np.asarray(jax.vmap(lambda x, u, w: open_loop_rollout(jspec, x, u, w))(
        jnp.asarray(x0), jnp.asarray(us), jnp.asarray(ws)))
    return xs, us, ws


@pytest.mark.parametrize("name", ["farm", "demo"])
def test_generated_model_solve_matches_jax_kernels(name):
    T, B = 8, 4
    jmake, tmake = _PROBLEMS[name]
    jspec, tspec = jmake(T), tmake(T)
    model = fk.device_model(tspec)
    assert model is not None and model.generated is not None, fk.model_reason(tspec)
    assert model.generated.nw == tspec.npar
    xs, us, ws = inputs(jspec, T, B, seed=7)
    jo = JaxOptions(**_BASE)
    ref = jax_make_batched_solve_fn(jspec, jo, interpret=True)(
        jnp.asarray(xs), jnp.asarray(us), jnp.asarray(ws))
    before = fk.SCORE_LAUNCHES.launches
    sol = make_batched_solve_fn(
        tspec, options_from_fields(dataclasses.asdict(jo)), device="cpu",
        dtype=torch.float64,
    )(*batch_from_numpy(xs, us, ws, device="cpu", dtype=torch.float64))
    assert fk.SCORE_LAUNCHES.launches == before     # CPU: plain versions only
    out = solution_to_numpy(sol)
    for f in ("iterations", "al_iterations", "status"):
        np.testing.assert_array_equal(out[f], np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("xs", "us", "duals", "max_violation", "objective"):
        want = np.asarray(getattr(ref, f))
        tol = (TOL_OBJECTIVE if f == "objective" else TOL) * max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(out[f], want, rtol=0, atol=tol, err_msg=f)
