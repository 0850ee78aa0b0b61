"""Full DDP (``Options.ddp``) of the port against the JAX package, the
counterpart of tests/test_ddp.py: the dynamics second derivatives
(core/spec.py::hess_fn, ops/derivatives.py::dynamics_hessians), the DDP
terms of ops/backward.py::riccati_step and backward_pass_scan, and the
per-instance and batched DDP solves, on the same numpy inputs in f64.

Tolerances: derivative stacks and one backward step or scan 1e-12
relative to the largest value (both sides are IEEE f64 and sum the same
products, in other orders where XLA fuses its reductions); DDP against
Gauss-Newton on linear dynamics xs 1e-8 (the associative scan of the
Gauss-Newton solve against DDP's reverse scan); the acrobot solve against
JAX's objective 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu import make_solve_fn as jax_make_solve_fn
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import acrobot as jax_acrobot
from iterativelqr_tpu.ops import backward as jbw
from iterativelqr_tpu.ops import derivatives as jdv
from iterativelqr_tpu_torch import Cost, Dynamics, Options, build_spec, make_batched_solve_fn, make_solve_fn
from iterativelqr_tpu_torch.models import acrobot, particle
from iterativelqr_tpu_torch.ops import backward
from iterativelqr_tpu_torch.ops import derivatives as dv
from test_torch_backward import close, stacks

torch.set_num_threads(1)


def _problem(mod, T):
    """(port spec, xs, us, ws) as tests/test_ddp.py builds them: x1 then
    zero states, controls 0.05 (numpy, f64)."""
    dynamics, objective, constraints, x1, _ = mod.problem(T, **(
        {"device": "cpu"} if mod is particle else {}))
    spec = build_spec(dynamics, objective, constraints)
    xs = np.zeros((T, spec.nx))
    xs[0] = x1.numpy()
    return spec, xs, np.full((T - 1, spec.nu), 0.05), np.zeros((T, 0))


def test_dynamics_hessians_match_jax_and_finite_differences():
    """fxx/fuu/fux of acrobot T=11 at random states and controls, one
    instance and three lanes, against JAX's stacks (1e-12) and fxx/fux
    against central differences of the port's dynamics (as
    tests/test_ddp.py holds JAX's)."""
    T = 11
    spec = build_spec(*acrobot.problem(T)[:3])
    jspec = jax_build_spec(*jax_acrobot.problem(T)[:3])
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((3, T, 4))
    us = rng.standard_normal((3, T - 1, 1))
    ws = np.zeros((3, T, 0))
    out = dv.dynamics_hessians(spec, *(torch.as_tensor(a) for a in (xs, us, ws)))
    ref = jax.vmap(lambda *a: jdv.dynamics_hessians(jspec, *a))(xs, us, ws)
    one = dv.dynamics_hessians(spec, *(torch.as_tensor(a[0]) for a in (xs, us, ws)))
    for a, b, c in zip(out, ref, one):
        assert a.shape == b.shape == (3,) + c.shape
        close(a, b, 1e-12)
        close(c, b[0], 1e-12)
    fxx, fuu, fux = (a.numpy() for a in one)
    assert fuu.shape == (T - 1, 4, 1, 1)
    f = lambda x, u: spec.dyn_eval[0](torch.as_tensor(x), torch.as_tensor(u),
                                      torch.zeros(0, dtype=torch.float64)).numpy()
    t, eps = 3, 1e-5
    x, u = xs[0, t], us[0, t]
    e = np.eye(4) * eps

    def jac_x(x_, u_):
        return np.stack([(f(x_ + e[a], u_) - f(x_ - e[a], u_)) / (2 * eps)
                         for a in range(4)], axis=1)

    for b in range(4):
        d = (jac_x(x + e[b], u) - jac_x(x - e[b], u)) / (2 * eps)
        np.testing.assert_allclose(fxx[t, :, :, b], d, rtol=2e-3, atol=2e-5)
        du = np.array([eps])
        d = (f(x + e[b], u + du) - f(x + e[b], u - du) - f(x - e[b], u + du)
             + f(x - e[b], u - du)) / (4 * eps * eps)
        np.testing.assert_allclose(fux[t, :, 0, b], d, rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("n,m", [(4, 1), (3, 2)])
def test_riccati_step_with_ddp_terms_matches_jax(n, m):
    """One DDP step and the whole DDP reverse scan against JAX's under
    ``jax.vmap``, per-lane reg in {0, 1e-3, 0.1, 2} (the state
    regularization and its diagonal share), a masked action at (3, 2);
    and at reg = 0 with zero second derivatives the DDP step equals the
    Gauss-Newton step exactly."""
    rng = np.random.default_rng(10 + n)
    B, Tm1 = 5, 8
    st = stacks(rng, B, Tm1, n, m)
    f2 = [0.05 * rng.standard_normal((B, Tm1, n) + s) for s in ((n, n), (m, m), (m, n))]
    f2[0] = f2[0] + np.swapaxes(f2[0], -1, -2)
    f2[1] = f2[1] + np.swapaxes(f2[1], -1, -2)
    um = np.ones((Tm1, m), bool)
    if m > 1:
        um[:, -1] = False
    reg = np.array([0.0, 1e-3, 0.1, 0.0, 2.0])
    t = [torch.as_tensor(a) for a in st]
    f2_t = tuple(torch.as_tensor(a) for a in f2)
    out = backward.backward_pass_scan(*t, torch.as_tensor(um), torch.as_tensor(reg), f2=f2_t)
    ref = jax.vmap(lambda *a: jbw.backward_pass_scan(*a[:7], um, a[7], f2=a[8:]))(*st, reg, *f2)
    for a, b in zip(out, ref):
        close(a, b, 1e-12)
    P, p = st[4][:, -1], st[2][:, -1]
    umf = um[3].astype(np.float64)
    args = [torch.as_tensor(a[:, 3]) for a in st]
    step = backward.riccati_step(torch.as_tensor(P), torch.as_tensor(p), *args, torch.as_tensor(umf),
                                 torch.as_tensor(reg), f2_t=tuple(a[:, 3] for a in f2_t))
    ref_step = jax.vmap(lambda P, p, *a: jbw.riccati_step(P, p, *a[:7], umf, a[7], f2_t=a[8:]))(
        P, p, *(a[:, 3] for a in st), reg, *(a[:, 3] for a in f2))
    for a, b in zip(step, ref_step):
        close(a, b, 1e-12)
    zero = torch.zeros(B, dtype=torch.float64)
    gn = backward.riccati_step(torch.as_tensor(P), torch.as_tensor(p), *args, torch.as_tensor(umf), zero)
    ddp = backward.riccati_step(torch.as_tensor(P), torch.as_tensor(p), *args, torch.as_tensor(umf), zero,
                                f2_t=tuple(torch.zeros_like(a[:, 3]) for a in f2_t))
    for a, b in zip(ddp, gn):
        assert torch.equal(a, b)


def test_ddp_equals_gauss_newton_on_linear_dynamics():
    """Particle T=11 (linear dynamics, zero second derivatives): the DDP
    solve takes the Gauss-Newton solve's iterations and iterates."""
    spec, xs, us, ws = _problem(particle, 11)
    args = [torch.as_tensor(a) for a in (xs, us, ws)]
    gn = make_solve_fn(spec, Options(), device="cpu")(*args)
    ddp = make_solve_fn(spec, Options(ddp=True), device="cpu")(*args)
    assert int(gn.iterations) == int(ddp.iterations)
    np.testing.assert_allclose(ddp.xs.numpy(), gn.xs.numpy(), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(float(ddp.objective), float(gn.objective), rtol=1e-10)


def test_ddp_acrobot_matches_jax():
    """Acrobot T=11 per instance with ddp=True (x0 = 0.02 N(0,1) from numpy
    seed 1, controls 0.05, states rolled out open loop), capped at 12
    iterations a round and 3 rounds: iterations and AL rounds equal to
    JAX's per-instance DDP, objective and violation within 1e-8, xs within
    1e-8 of their largest value."""
    from test_torch_backward import one_instance

    jspec, tspec, xs, us, ws = one_instance(11)
    kw = dict(ddp=True, max_iterations=12, max_dual_updates=3)
    ref = jax.jit(jax_make_solve_fn(jspec, JaxOptions(**kw)))(*(jnp.asarray(a) for a in (xs, us, ws)))
    sol = make_solve_fn(tspec, Options(**kw), device="cpu")(*(torch.as_tensor(a) for a in (xs, us, ws)))
    for name in ("iterations", "al_iterations"):
        assert int(getattr(sol, name)) == int(getattr(ref, name)), name
    for name, tol in (("objective", 1e-8), ("max_violation", 1e-8), ("xs", 1e-8)):
        close(getattr(sol, name), getattr(ref, name), tol)


def test_ddp_batched_matches_single():
    """The batched DDP solve (the vmap route: ddp is not SL-eligible) on
    particle T=11, B=4, initial states x1 + 0.02 N(0,1) from numpy seed 0,
    against per-instance DDP solves: equal iterations, xs within 1e-8."""
    spec, xs, us, ws = _problem(particle, 11)
    B = 4
    xs_b = np.zeros((B,) + xs.shape)
    xs_b[:, 0] = xs[0] + 0.02 * np.random.default_rng(0).standard_normal((B, spec.nx))
    us_b, ws_b = np.broadcast_to(us, (B,) + us.shape), np.broadcast_to(ws, (B,) + ws.shape)
    opts = Options(ddp=True, record_traces=False)
    sol_b = make_batched_solve_fn(spec, opts, device="cpu", dtype=torch.float64)(
        *(torch.as_tensor(np.ascontiguousarray(a)) for a in (xs_b, us_b, ws_b)))
    solve1 = make_solve_fn(spec, opts, device="cpu")
    for i in range(B):
        sol1 = solve1(*(torch.as_tensor(np.ascontiguousarray(a[i])) for a in (xs_b, us_b, ws_b)))
        assert int(sol_b.iterations[i]) == int(sol1.iterations)
        np.testing.assert_allclose(sol_b.xs[i].numpy(), sol1.xs.numpy(), rtol=1e-8, atol=1e-8)


def test_ddp_regularization_cures_null_fu_indefiniteness():
    """tests/test_ddp.py's case: f = [x0 + u0, x1 - u1^2] makes Vx.fuu
    indefinite along null(fu), which only the diagonal share of the state
    regularization reaches; the port's solve stays finite, as JAX's."""
    T = 6
    dyn = Dynamics(lambda x, u: torch.stack([x[0] + u[0], x[1] - u[1] ** 2]), 2, 2)
    stage = Cost(lambda x, u: x[1] + 0.5 * x[0] ** 2 + 1e-4 * torch.dot(u, u), 2, 2)
    term = Cost(lambda x, u: x[1] + 0.5 * x[0] ** 2, 2, 0)
    spec = build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term], None)
    xs = torch.zeros((T, 2), dtype=torch.float64)
    xs[0, 0] = 1.0
    sol = make_solve_fn(spec, Options(ddp=True), device="cpu")(
        xs, torch.zeros((T - 1, 2), dtype=torch.float64), torch.zeros((T, 0), dtype=torch.float64))
    assert bool(torch.isfinite(sol.xs).all()), "NaN trajectory: PD retry failed"
    assert bool(torch.isfinite(sol.K).all())


def test_ddp_option_refusals():
    """What the JAX package refuses with ddp=True the port refuses too: a
    recursion that cannot carry the DDP terms (associative, packed), the SL
    batched solver, and a ``backward_impl`` override; scan and auto run."""
    spec = build_spec(*acrobot.problem(9)[:3])
    for kw in (dict(backward_pass="associative"), dict(backward_pass="packed"),
               dict(batched_solver="sl")):
        with pytest.raises(ValueError):
            JaxOptions(ddp=True, **kw)
        with pytest.raises(ValueError):
            Options(ddp=True, **kw)
    with pytest.raises(ValueError, match="backward_impl"):
        make_solve_fn(spec, Options(ddp=True), backward_impl=backward.backward_pass_scan,
                      device="cpu")
    Options(ddp=True, backward_pass="scan")
    Options(ddp=True)
