"""The port's SL solve with forward_kernel="pallas" of a user problem that
takes the ops the device-function generator lowers since it took products,
constant indices and the wider math (``tests/torch_user_problems.py::
mixed_problem``: ``x @ Q @ x``, ``x[idx]`` with a closed-over LongTensor,
``atan2`` and a ``vector_norm`` obstacle row, at (3, 2)) against the JAX
package's SL solve with its Pallas K3/K4 in interpret mode, in f64, T=6,
B=4.  As tests/test_torch_generated_solve.py holds its problems: equal
iterations, AL iterations and status per lane; trajectories, duals and
violations within 1e-10 of the field's largest magnitude, the objective
within 1e-9."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_generated_solve import _BASE, TOL, TOL_OBJECTIVE, inputs
from torch_user_problems import mixed_problem

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.core.spec import Constraint as JConstraint
from iterativelqr_tpu.core.spec import Cost as JCost
from iterativelqr_tpu.core.spec import Dynamics as JDynamics
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.parallel.batch import make_batched_solve_fn as jax_make_batched_solve_fn
from iterativelqr_tpu_torch import make_batched_solve_fn
from iterativelqr_tpu_torch.convert import batch_from_numpy, options_from_fields, solution_to_numpy
from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk

torch.set_num_threads(1)


def jax_mixed(T):
    """tests/torch_user_problems.py::mixed_problem in jnp."""
    Q = jnp.array([[1.0, 0.2], [0.2, 0.5]])
    goal = jnp.array([1.0, 0.5])
    center = jnp.array([0.5, 0.2])
    idx = np.array([0, 1])

    def dynamics(x, u):
        v = jnp.stack([u[0] * jnp.cos(x[2]), u[0] * jnp.sin(x[2]), u[1]])
        return x + 0.1 * v

    def heading(x):
        d = x[2] - 0.3
        return jnp.arctan2(jnp.sin(d), jnp.cos(d))

    def stage_cost(x, u):
        e = x[idx] - goal
        return e @ Q @ e + 0.1 * heading(x) ** 2 + 0.05 * (u @ u)

    def stage_con(x, u):
        obstacle = 0.15 - jnp.linalg.norm(x[idx] - center)
        return obstacle.reshape(1)

    dyn = JDynamics(dynamics, 3, 2)
    stage = JCost(stage_cost, 3, 2)
    term = JCost(lambda x, u: 10.0 * ((x[idx] - goal) @ Q @ (x[idx] - goal)), 3, 0)
    con = JConstraint(stage_con, 3, 2, indices_inequality=(0,))
    goal_con = JConstraint(lambda x, u: x[idx] - goal, 3, 0)
    return jax_build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                          [con] * (T - 1) + [goal_con])


def test_mixed_ops_problem_matches_jax_kernels():
    T, B = 6, 4
    jspec, tspec = jax_mixed(T), mixed_problem(T)
    model = fk.device_model(tspec)
    assert model is not None and model.generated is not None, fk.model_reason(tspec)
    names = {name for p in model.generated.programs if p is not None for name, _ in p.ops}
    assert {"atan2", "sqrt"} <= names
    xs, us, ws = inputs(jspec, T, B, seed=9)
    jo = JaxOptions(**_BASE)
    # compiled whole: the interpret-mode kernels dispatch op by op otherwise
    ref = jax.jit(jax_make_batched_solve_fn(jspec, jo, interpret=True))(
        jnp.asarray(xs), jnp.asarray(us), jnp.asarray(ws))
    sol = make_batched_solve_fn(
        tspec, options_from_fields(dataclasses.asdict(jo)), device="cpu",
        dtype=torch.float64,
    )(*batch_from_numpy(xs, us, ws, device="cpu", dtype=torch.float64))
    out = solution_to_numpy(sol)
    for f in ("iterations", "al_iterations", "status"):
        np.testing.assert_array_equal(out[f], np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("xs", "us", "duals", "max_violation", "objective"):
        want = np.asarray(getattr(ref, f))
        tol = (TOL_OBJECTIVE if f == "objective" else TOL) * max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(out[f], want, rtol=0, atol=tol, err_msg=f)
    # the lanes do work: AL rounds run and the obstacle row is active somewhere
    assert int(out["al_iterations"].max()) >= 1
