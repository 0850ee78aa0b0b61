"""Receding-horizon MPC of the port (iterativelqr_tpu_torch/core/mpc.py)
against the JAX package's (iterativelqr_tpu/core/mpc.py), the counterpart
of tests/test_mpc.py, on the particle in f64: one controller step and two
from the same state and measurement (action, xs, duals and penalty within
1e-10 of their largest value), the disturbance-rejection scenario with
the same numpy noise on both sides, the per-step iteration budget, and
one step of a batched farm (shift, closed-loop re-roll over lanes, warm
SL solve with capped penalties) against the same sequence built from the
JAX functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.core.mpc import make_mpc_controller as jax_make_mpc_controller
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import particle as jax_particle
from iterativelqr_tpu.ops.rollout import closed_loop_rollout as jax_closed_loop_rollout
from iterativelqr_tpu.parallel.batch import make_batched_solve_fn as jax_make_batched
from iterativelqr_tpu_torch import Options, build_spec, make_batched_solve_fn
from iterativelqr_tpu_torch.core.mpc import make_mpc_controller
from iterativelqr_tpu_torch.models import particle
from iterativelqr_tpu_torch.ops.rollout import closed_loop_rollout, open_loop_rollout
from test_torch_backward import close

torch.set_num_threads(1)


def _both(T):
    jspec = jax_build_spec(*jax_particle.problem(T)[:3])
    dyn, cost, con, _, xT = particle.problem(T, device="cpu")
    return jspec, build_spec(dyn, cost, con), xT.numpy()


def _zero_plan(spec, T):
    return np.zeros((T, spec.nx)), np.zeros((T - 1, spec.nu)), np.zeros((T, 0))


@pytest.mark.parametrize("kw", [{}, dict(penalty_carry_cap=5.0, shift_fill="zero")])
def test_mpc_steps_match_jax(kw):
    """Two steps from the zero plan at x = (0.3, -0.1) (T=9, default
    Options): the second carries the first's duals and penalties (capped
    at 5 in the second case, with the zero-filled action tail)."""
    T = 9
    jspec, tspec, _ = _both(T)
    xs, us, ws = _zero_plan(tspec, T)
    jinit, jstep = jax_make_mpc_controller(jspec, JaxOptions(), **kw)
    init, step = make_mpc_controller(tspec, Options(), **kw, device="cpu")
    jstep = jax.jit(jstep)
    jstate = jinit(jnp.asarray(xs), jnp.asarray(us))
    state = init(torch.as_tensor(xs), torch.as_tensor(us))
    grown = []
    for x in ((0.3, -0.1), (0.25, 0.05)):
        grown.append(float(state.penalty.max()))
        ref = jstep(jstate, jnp.asarray(x), jnp.asarray(ws))
        out = step(state, torch.as_tensor(np.asarray(x)), torch.as_tensor(ws))
        assert int(out.solution.iterations) == int(ref.solution.iterations)
        close(out.action, ref.action)
        for f in ("xs", "duals", "penalty"):
            close(getattr(out.state, f), getattr(ref.state, f))
        jstate, state = ref.state, out.state
    if "penalty_carry_cap" in kw:
        assert grown[1] > 5.0   # the first solve's penalties: the cap bit


def test_mpc_disturbance_rejection_matches_jax():
    """tests/test_mpc.py's scenario (particle T=11, 12 steps from (-0.5,
    0.3), noise 0.02 N(0,1) on the first 6 steps), the noise from numpy
    seed 0 on both sides: every action within 1e-8 of JAX's, and the
    final plan reaches the goal within 5e-3."""
    T = 11
    jspec, tspec, xT = _both(T)
    opts = dict(verbose=False, record_traces=False)
    jinit, jstep = jax_make_mpc_controller(jspec, JaxOptions(**opts), carry_duals=True)
    init, step = make_mpc_controller(tspec, Options(**opts), carry_duals=True, device="cpu")
    jstep = jax.jit(jstep)
    xs, us, ws = _zero_plan(tspec, T)
    jstate = jinit(jnp.asarray(xs), jnp.asarray(us))
    state = init(torch.as_tensor(xs), torch.as_tensor(us))
    f = tspec.dyn_eval[0]
    rng = np.random.default_rng(0)
    x = torch.tensor([-0.5, 0.3], dtype=torch.float64)
    w0 = torch.zeros(0, dtype=torch.float64)
    for i in range(12):
        ref = jstep(jstate, jnp.asarray(x.numpy()), jnp.asarray(ws))
        out = step(state, x, torch.as_tensor(ws))
        jstate, state = ref.state, out.state
        assert bool(torch.isfinite(out.action).all())
        close(out.action, ref.action, 1e-8)
        noise = 0.02 * rng.standard_normal(2) if i < 6 else np.zeros(2)
        x = f(x, out.action, w0) + torch.as_tensor(noise)
    sol = out.solution
    assert float(sol.max_violation) <= 5.0e-3
    np.testing.assert_allclose(sol.xs[-1].numpy(), xT, atol=5.0e-3)


def test_mpc_step_iteration_budget():
    """max_step_iterations=8 caps every step's total iterations (the
    solver's max_total_iterations) and the controller stays stable:
    particle T=11, 12 steps, noise 0.002 N(0,1) from numpy seed 0."""
    T = 11
    _, tspec, _ = _both(T)
    init, step = make_mpc_controller(tspec, Options(verbose=False), max_step_iterations=8,
                                     device="cpu")
    xs, us, ws = (torch.as_tensor(a) for a in _zero_plan(tspec, T))
    state = init(xs, us)
    rng = np.random.default_rng(0)
    x = torch.tensor([0.3, -0.1], dtype=torch.float64)
    f = tspec.dyn_eval[0]
    for _ in range(12):
        out = step(state, x, ws)
        assert int(out.solution.iterations) <= 8
        state = out.state
        x = f(x, out.action, ws[0]) + torch.as_tensor(0.002 * rng.standard_normal(2))
    assert float(out.solution.max_violation) < 5.0e-2


FARM_OPTS = dict(verbose=False, record_traces=False, objective_tolerance=1.0e-8,
                 max_penalty=1.0e6, forward_kernel="scan")


def _port_farm_step(spec, solve_warm, x_meas, sol, ws):
    """examples/mpc_farm.py's farm step from the port's pieces: shift every
    plan, re-roll it closed-loop from the measured states over the lane
    axis, warm SL solve with the shifted duals and capped penalties."""
    shift = lambda a: torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    xs0, us0 = closed_loop_rollout(spec, shift(sol.xs), shift(sol.us), ws, shift(sol.K),
                                   torch.zeros_like(sol.k), 0.0, x0=x_meas)
    pen0 = torch.clamp(shift(sol.penalty), max=1.0e4)
    return solve_warm(xs0, us0, ws, shift(sol.duals), pen0)


def test_farm_step_matches_jax():
    """A cold SL solve of 8 particle controllers (T=11, x0 = 0.3 N(0,1)
    from numpy seed 0, zero controls), then one farm step from measured
    states 0.005 N(0,1) off each plan's x_1, against the same step built
    from the JAX functions (``jax.vmap(closed_loop_rollout)`` and the JAX
    SL solver, its kernels in interpret mode) on the port's cold
    solution: equal iterations per lane, xs within 1e-10 of their largest
    value, and every plan feasible."""
    T, B = 11, 8
    jspec, tspec, _ = _both(T)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.normal(0.0, 0.3, (B, 2)))
    us = torch.zeros((B, T - 1, 1), dtype=torch.float64)
    ws = torch.zeros((B, T, 0), dtype=torch.float64)
    xs = open_loop_rollout(tspec, x0, us, ws)
    cold = make_batched_solve_fn(tspec, Options(**FARM_OPTS), device="cpu",
                                 dtype=torch.float64)(xs, us, ws)
    warm = make_batched_solve_fn(tspec, Options(**FARM_OPTS), dual_warm_start=True,
                                 device="cpu", dtype=torch.float64)
    x_meas = cold.xs[:, 1] + torch.as_tensor(rng.normal(0.0, 0.005, (B, 2)))
    out = _port_farm_step(tspec, warm, x_meas, cold, ws)

    j = {f: jnp.asarray(getattr(cold, f).numpy()) for f in ("xs", "us", "K", "k", "duals", "penalty")}
    jshift = lambda a: jnp.concatenate([a[:, 1:], a[:, -1:]], axis=1)
    jws = jnp.asarray(ws.numpy())
    xs0, us0 = jax.vmap(lambda x, xb, ub, Kb, kb, w: jax_closed_loop_rollout(
        jspec, xb.at[0].set(x), ub, w, Kb, kb, 0.0))(
        jnp.asarray(x_meas.numpy()), jshift(j["xs"]), jshift(j["us"]), jshift(j["K"]),
        jnp.zeros_like(j["k"]), jws)
    jwarm = jax_make_batched(jspec, JaxOptions(**FARM_OPTS), dual_warm_start=True, interpret=True)
    ref = jwarm(xs0, us0, jws, jshift(j["duals"]), jnp.minimum(jshift(j["penalty"]), 1.0e4))
    np.testing.assert_array_equal(out.iterations.numpy(), np.asarray(ref.iterations))
    close(out.xs, ref.xs)
    assert float(out.max_violation.max()) < 5e-3
