"""The port's Solver shell and printing (iterativelqr_tpu_torch/core/
solver.py, utils/printing.py) against the JAX package's ``Solver`` on the
same problems, in f64: equal iteration counts, and the trajectories within
1e-10 of their largest value (a Solver solve is one per-instance solve
with the literal defaults, so its backward pass is the associative scan).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Constraint as JConstraint
from iterativelqr_tpu import Cost as JCost
from iterativelqr_tpu import Dynamics as JDynamics
from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu import Solver as JaxSolver
from iterativelqr_tpu import rollout as jax_rollout
from iterativelqr_tpu.models import car as jax_car
from iterativelqr_tpu_torch import Cost, Dynamics, Options, Solver, rollout
from iterativelqr_tpu_torch.models import car

from test_torch_backward import close

torch.set_num_threads(1)

T_CAR = 12


def jax_host_copy(solver):
    """Break the JAX package's buffer chain between warm solves: feeding a
    jitted f64 solve's outputs back as its inputs corrupts XLA:CPU's heap
    (a buffer-aliasing bug of XLA:CPU in x64); host copies avoid it."""
    for name in ("_xs", "_us", "_duals", "_penalty"):
        v = getattr(solver, name)
        if v is not None:
            setattr(solver, name, jnp.asarray(np.asarray(v)))


def solvers(options):
    """A JAX and a port Solver on the car T=12, warm-started from the
    reference controls and their rollout."""
    jd, jo, jc, jx1, _ = jax_car.problem(T_CAR)
    js = JaxSolver(jd, jo, jc, options=JaxOptions(**options))
    jus = jax_car.initial_controls(T_CAR)
    js.initialize_controls(jus).initialize_states(jax_rollout(jd, jx1, jus))
    d, o, c, x1, _ = car.problem(T_CAR)
    ts = Solver(d, o, c, options=Options(**options), device="cpu")
    us = car.initial_controls(T_CAR)
    ts.initialize_controls(us).initialize_states(rollout(d, x1.to(torch.float64), us))
    return js, ts


def assert_same(sol, ref):
    for name in ("iterations", "al_iterations", "status"):
        assert int(getattr(sol, name)) == int(getattr(ref, name)), name
    for name in ("xs", "us", "objective", "max_violation", "duals", "penalty"):
        close(getattr(sol, name), getattr(ref, name))


def test_solver_solve_warm_solve_reset_match_jax():
    js, ts = solvers(dict(verbose=False))
    assert_same(ts.solve(), js.solve())
    jax_host_copy(js)
    # the warm solve carries the duals and penalties: the warm solver is
    # built at this first warm solve
    assert ts._warm_solve_fn is None
    warm, jwarm = ts.warm_solve(), js.warm_solve()
    assert ts._warm_solve_fn is not None
    assert_same(warm, jwarm)
    jax_host_copy(js)
    ts.reset_duals()
    js.reset_duals()
    assert ts._duals is None and ts._penalty is None
    assert_same(ts.warm_solve(), js.warm_solve())   # a cold AL state again
    xs, us = ts.get_trajectory()
    jxs, jus = js.get_trajectory()
    assert len(xs) == T_CAR and len(us) == T_CAR - 1
    for a, b in zip(xs + us, jxs + jus):
        close(a, b)
    cx, cu = ts.current_trajectory()
    assert all(torch.equal(a, b) for a, b in zip(cx + cu, xs + us))


def parameter_problem(pkg, T):
    """tests/test_utils.py's per-timestep parameter problem for ``pkg``
    ("jax" or "torch")."""
    if pkg == "jax":
        A = jnp.array([[1.0, 0.2], [0.0, 1.0]])
        dyn = JDynamics(lambda x, u, w: A @ x + jnp.array([0.0, 0.2]) * u[0] + w,
                        2, 1, num_parameter=2)
        stage = JCost(lambda x, u, w: 0.1 * (x @ x + u @ u), 2, 1, num_parameter=2)
        term = JCost(lambda x, u, w: 0.1 * (x @ x), 2, 0, num_parameter=2)
        return dyn, stage, term, [0.01 * jnp.ones(2) for _ in range(T)]
    A = torch.tensor([[1.0, 0.2], [0.0, 1.0]], dtype=torch.float64)
    b = torch.tensor([0.0, 0.2], dtype=torch.float64)
    dyn = Dynamics(lambda x, u, w: A @ x + b * u[0] + w, 2, 1, num_parameter=2)
    stage = Cost(lambda x, u, w: 0.1 * (x @ x + u @ u), 2, 1, num_parameter=2)
    term = Cost(lambda x, u, w: 0.1 * (x @ x), 2, 0, num_parameter=2)
    return dyn, stage, term, [0.01 * torch.ones(2, dtype=torch.float64) for _ in range(T)]


def test_solver_parameters_ctor_and_property():
    """Per-timestep parameters through the constructor and the property."""
    T = 7
    dyn, stage, term, params = parameter_problem("torch", T)
    solver = Solver([dyn] * (T - 1), [stage] * (T - 1) + [term], parameters=params,
                    options=Options(verbose=False), device="cpu")
    assert solver.parameters.shape == (T, 2)
    np.testing.assert_allclose(solver.parameters[0].numpy(), 0.01)
    sol = solver.solve()
    jd, js_, jt, jp = parameter_problem("jax", T)
    ref = JaxSolver([jd] * (T - 1), [js_] * (T - 1) + [jt], parameters=jp,
                    options=JaxOptions(verbose=False)).solve()
    assert bool(torch.isfinite(sol.objective))
    assert_same(sol, ref)
    # the setter replaces the trajectory the next solve reads
    solver.parameters = np.full((T, 2), 0.02)
    assert solver.parameters.dtype == torch.float64
    np.testing.assert_allclose(solver.parameters.numpy(), 0.02)
    assert bool(torch.isfinite(solver.solve().objective))


@pytest.mark.parametrize("live", [False, True], ids=["verbose", "live_progress"])
def test_solver_printing(capsys, live):
    """verbose prints the banner and the per-iteration table from the
    traces; live_progress prints one line per AL round while it runs."""
    T = 7
    dyn, stage, term, params = parameter_problem("torch", T)
    solver = Solver([dyn] * (T - 1), [stage] * (T - 1) + [term], parameters=params,
                    options=Options(verbose=not live, live_progress=live), device="cpu")
    sol = solver.solve()
    out = capsys.readouterr().out
    if live:
        assert "[al  0]" in out and "viol" in out and "objective:" not in out
        assert out.count("  [al") == int(sol.al_iterations)
    else:
        assert "PyTorch" in out and "objective:" in out and "dual updates" in out
        rows = [ln for ln in out.splitlines() if ln[:3].strip().isdigit()]
        assert len(rows) == int(sol.trace_mask.sum())
