"""The port's parameter sensitivities (iterativelqr_tpu_torch/ops/
sensitivity.py) against the JAX package's on tests/test_sensitivity.py's
tracking problem, in f64: the gradient at the same solution within 1e-10 of
its largest value (both sides differentiate the same Lagrangian with the
costates of the same backward pass), and the port's own solve's gradient
against central finite differences of its re-solved optimal value, within
that test's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from iterativelqr_tpu import Constraint as JConstraint
from iterativelqr_tpu import Cost as JCost
from iterativelqr_tpu import Dynamics as JDynamics
from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu import make_solve_fn as jax_make_solve_fn
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.ops.sensitivity import parameter_gradient as jax_parameter_gradient
from iterativelqr_tpu_torch import (Constraint, Cost, Dynamics, Options, build_spec,
                                    make_solve_fn, parameter_gradient,
                                    solution_parameter_gradient)
from iterativelqr_tpu_torch.ops import derivatives as dv

from test_torch_backward import close

torch.set_num_threads(1)

TIGHT = dict(verbose=False, objective_tolerance=1e-10, lagrangian_gradient_tolerance=1e-10,
             constraint_tolerance=1e-8, max_dual_updates=14)


def jax_setup(T):
    A = jnp.array([[1.0, 0.2], [0.0, 1.0]])
    B = jnp.array([0.0, 0.2])
    dyn = JDynamics(lambda x, u, w: A @ x + B * u[0], 2, 1, num_parameter=2)
    stage = JCost(lambda x, u, w: 0.1 * jnp.sum((x - w) ** 2) + 0.1 * jnp.sum(u**2),
                  2, 1, num_parameter=2)
    term = JCost(lambda x, u, w: 0.1 * jnp.sum((x - w) ** 2), 2, 0, num_parameter=2)
    goal = JConstraint(lambda x, u, w: x - w, 2, 0, num_parameter=2)
    return jax_build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                          [JConstraint() for _ in range(T - 1)] + [goal])


def torch_setup(T):
    """tests/test_sensitivity.py::_setup as torch functions: stage cost
    0.1 ||x - w||^2 + 0.1 u^2 with a 2-vector parameter w per timestep,
    terminal equality x = w."""
    A = torch.tensor([[1.0, 0.2], [0.0, 1.0]], dtype=torch.float64)
    B = torch.tensor([0.0, 0.2], dtype=torch.float64)
    dyn = Dynamics(lambda x, u, w: A @ x + B * u[0], 2, 1, num_parameter=2)
    stage = Cost(lambda x, u, w: 0.1 * torch.sum((x - w) ** 2) + 0.1 * torch.sum(u**2),
                 2, 1, num_parameter=2)
    term = Cost(lambda x, u, w: 0.1 * torch.sum((x - w) ** 2), 2, 0, num_parameter=2)
    goal = Constraint(lambda x, u, w: x - w, 2, 0, num_parameter=2)
    return build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                      [Constraint() for _ in range(T - 1)] + [goal])


def fields(sol):
    return [np.asarray(getattr(sol, f)) for f in ("xs", "us", "duals", "penalty")]


def test_parameter_gradient_matches_jax_and_fd():
    T = 9
    jspec, tspec = jax_setup(T), torch_setup(T)
    rng = np.random.default_rng(3)
    ws = 0.3 * rng.standard_normal((T, 2))
    xs0 = np.zeros((T, 2))
    xs0[0] = [0.5, -0.2]
    us0 = np.zeros((T - 1, 1))
    jsol = jax.jit(jax_make_solve_fn(jspec, JaxOptions(**TIGHT)))(
        *(jnp.asarray(a) for a in (xs0, us0, ws)))
    jxs, jus, jduals, jpen = fields(jsol)
    g_ref = jax_parameter_gradient(jspec, JaxOptions(**TIGHT), jxs, jus, ws, jduals, jpen)
    # the same solution, both gradients
    g_at_ref = parameter_gradient(tspec, Options(**TIGHT),
                                  *(torch.as_tensor(a) for a in (jxs, jus, ws, jduals, jpen)))
    close(g_at_ref, g_ref)

    solve = make_solve_fn(tspec, Options(**TIGHT), device="cpu")
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    sol = solve(t(xs0), t(us0), t(ws))
    assert float(sol.max_violation) <= 1e-8
    assert int(sol.iterations) == int(jsol.iterations)
    g = solution_parameter_gradient(tspec, Options(**TIGHT), sol, t(ws))
    assert g.shape == (T, 2)
    close(g, g_ref, 1e-8)

    def value(w):
        s = solve(t(xs0), t(us0), t(w))
        return float(dv.total_cost(tspec, s.xs, s.us, t(w)))

    eps = 1e-5
    pick = np.random.default_rng(0)
    for _ in range(4):
        i, j = int(pick.integers(0, T)), int(pick.integers(0, 2))
        e = np.zeros_like(ws)
        e[i, j] = eps
        fd = (value(ws + e) - value(ws - e)) / (2 * eps)
        assert np.isclose(float(g[i, j]), fd, rtol=2e-3, atol=2e-5), (i, j, float(g[i, j]), fd)


def test_parameter_gradient_batched_matches_jax():
    """The batched form (one leading lane axis) against ``jax.vmap`` of the
    JAX function, at the JAX batch's solutions, and on the port's own
    batched solve."""
    T, B = 7, 4
    jspec, tspec = jax_setup(T), torch_setup(T)
    opts = dict(verbose=False)
    ws = 0.2 * np.random.default_rng(0).standard_normal((B, T, 2))
    xs0, us0 = np.zeros((B, T, 2)), np.zeros((B, T - 1, 1))
    jsol = jax.jit(jax.vmap(jax_make_solve_fn(jspec, JaxOptions(**opts))))(
        *(jnp.asarray(a) for a in (xs0, us0, ws)))
    jxs, jus, jduals, jpen = fields(jsol)
    g_ref = jax.jit(jax.vmap(lambda *a: jax_parameter_gradient(jspec, JaxOptions(**opts), *a)))(
        jxs, jus, ws, jduals, jpen)
    g = parameter_gradient(tspec, Options(**opts),
                           *(torch.as_tensor(a) for a in (jxs, jus, ws, jduals, jpen)))
    assert g.shape == (B, T, 2)
    close(g, g_ref)
    # the port's own batched solve: the same iterations, the same gradients
    sol = make_solve_fn(tspec, Options(**opts), device="cpu").vmap()(
        *(torch.as_tensor(a) for a in (xs0, us0, ws)))
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(jsol.iterations))
    g_own = solution_parameter_gradient(tspec, Options(**opts), sol, torch.as_tensor(ws))
    close(g_own, g_ref, 1e-8)
    assert float(g_own[:, 0, 0].std()) > 1e-8
