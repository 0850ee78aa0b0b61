"""The per-instance stacks, rollouts and line search of the port
(iterativelqr_tpu_torch/ops/derivatives.py, rollout.py, forward.py) against
the JAX package's functions under ``jax.vmap``, on car (time-varying stage
types: a constraint block at every step, a terminal one of its own) and
acrobot (an empty stage constraint block), in f64 from numpy seeds.

Tolerance 1e-10 relative to the largest value (IEEE f64 on both sides,
sums in other orders); step sizes, statuses and accepted candidates equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import acrobot as jax_acrobot
from iterativelqr_tpu.models import car as jax_car
from iterativelqr_tpu.ops import al as jal
from iterativelqr_tpu.ops import derivatives as jdv
from iterativelqr_tpu.ops import forward as jfw
from iterativelqr_tpu.ops import rollout as jro
from iterativelqr_tpu_torch import Options, build_spec, rollout
from iterativelqr_tpu_torch.models import acrobot, car
from iterativelqr_tpu_torch.ops import al, derivatives as dv, forward as fw
from iterativelqr_tpu_torch.ops import rollout as ro

from test_torch_backward import close

torch.set_num_threads(1)

T, B = 10, 6


@pytest.fixture(scope="module", params=["car", "acrobot"])
def case(request):
    jm, tm = {"car": (jax_car, car), "acrobot": (jax_acrobot, acrobot)}[request.param]
    jspec = jax_build_spec(*jm.problem(T)[:3])
    tspec = build_spec(*tm.problem(T)[:3])
    rng = np.random.default_rng(11)
    nx, nu, nc = jspec.nx, jspec.nu, jspec.nc
    x0 = np.asarray(jm.problem(T)[3]) + 0.05 * rng.standard_normal((B, nx))
    us = 0.3 * rng.standard_normal((B, T - 1, nu))
    if request.param == "car":
        us[..., 0] += 0.7
    ws = np.zeros((B, T, 0))
    xs = np.array(jax.vmap(lambda x, u, w: jro.open_loop_rollout(jspec, x, u, w))(
        jnp.asarray(x0), jnp.asarray(us), jnp.asarray(ws)))
    K = 0.1 * rng.standard_normal((B, T - 1, nu, nx))
    k = 0.2 * rng.standard_normal((B, T - 1, nu))
    duals = np.abs(rng.standard_normal((B, T, nc))) * (rng.uniform(size=(B, T, nc)) < 0.5)
    pen = rng.uniform(1.0, 20.0, (B, T, nc))
    arrays = dict(xs=xs, us=us, ws=ws, K=K, k=k, duals=duals, pen=pen, model=tm)
    return jspec, tspec, arrays


def t(a):
    return torch.as_tensor(a)


def test_derivative_stacks_match(case):
    jspec, tspec, a = case
    args = (a["xs"], a["us"], a["ws"])
    for name in ("stage_costs", "total_cost", "cost_gradients", "cost_hessians",
                 "dynamics_values", "dynamics_jacobians", "constraint_values",
                 "constraint_jacobians"):
        out = getattr(dv, name)(tspec, *(t(x) for x in args))
        ref = jax.vmap(lambda *x: getattr(jdv, name)(jspec, *x))(*args)
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(out, ref):
            close(o.numpy(), np.asarray(r))
        # one instance, no lane axis
        one = getattr(dv, name)(tspec, *(t(x[0]) for x in args))
        for o, r in zip(one if isinstance(one, tuple) else (one,), out):
            close(o.numpy(), r[0].numpy())


def test_rollouts_match(case):
    jspec, tspec, a = case
    alpha = 0.5 ** np.arange(B)
    xs, us = ro.closed_loop_rollout(tspec, t(a["xs"]), t(a["us"]), t(a["ws"]),
                                    t(a["K"]), t(a["k"]), t(alpha))
    jxs, jus = jax.vmap(lambda *x: jro.closed_loop_rollout(jspec, *x))(
        a["xs"], a["us"], a["ws"], a["K"], a["k"], alpha)
    close(xs.numpy(), np.asarray(jxs))
    close(us.numpy(), np.asarray(jus))
    for kw in (dict(), dict(cost_only=True), dict(with_viol=True),
               dict(cost_only=True, with_viol=True)):
        out = ro.rollout_with_al_cost(
            tspec, t(a["xs"]), t(a["us"]), t(a["ws"]), t(a["K"]), t(a["k"]),
            t(alpha), t(a["duals"]), t(a["pen"]), **kw)
        ref = jax.vmap(lambda *x: jro.rollout_with_al_cost(jspec, *x, **kw))(
            a["xs"], a["us"], a["ws"], a["K"], a["k"], alpha, a["duals"], a["pen"])
        for o, r in zip(out, ref):
            assert (o is None) == (r is None)
            if o is not None:
                close(o.numpy(), np.asarray(r))
    ol = ro.open_loop_rollout(tspec, t(a["xs"][:, 0]), t(a["us"]), t(a["ws"]))
    close(ol.numpy(), a["xs"])
    dyn = a["model"].problem(T)[0]
    states = rollout(dyn, t(a["xs"][0, 0]), t(a["us"][0]))
    close(torch.stack(states).numpy(), a["xs"][0])


def test_sensitivities_and_slope_match(case):
    jspec, tspec, a = case
    fx, fu = jax.vmap(lambda *x: jdv.dynamics_jacobians(jspec, *x))(a["xs"], a["us"], a["ws"])
    fx, fu = np.array(fx), np.array(fu)
    zx, zu = fw.trajectory_sensitivities(t(fx), t(fu), t(a["K"]), t(a["k"]))
    jzx, jzu = jax.vmap(jfw.trajectory_sensitivities)(fx, fu, a["K"], a["k"])
    close(zx.numpy(), np.asarray(jzx))
    close(zu.numpy(), np.asarray(jzu))
    rng = np.random.default_rng(3)
    Qx, p = rng.standard_normal((2, B, T - 1, jspec.nx))
    Qu = rng.standard_normal((B, T - 1, jspec.nu))
    close(fw.armijo_slope(t(Qx), t(Qu), t(p), zx, zu).numpy(),
          np.asarray(jax.vmap(jfw.armijo_slope)(Qx, Qu, p, np.asarray(jzx), np.asarray(jzu))))


@pytest.mark.parametrize("kw", [
    dict(),                                            # Armijo, 17 candidates
    dict(line_search="none"),
    dict(constraint_aware_acceptance=True),
    dict(min_step_size=4e-3),                          # 8 candidates
])
def test_line_search_matches(case, kw):
    """Lanes whose Armijo test accepts a long step, a short one or none
    (slopes from steep descent to ascent)."""
    jspec, tspec, a = case
    jo, to = JaxOptions(**kw), Options(**kw)
    ineq = np.asarray(jspec.ineq_mask)
    slope = np.array([-50.0, -1.0, -1e-3, 0.0, 1.0, -1e4])

    def jobj(xs, us, ws, duals, pen):
        J = jdv.total_cost(jspec, xs, us, ws)
        c = jdv.constraint_values(jspec, xs, us, ws)
        return J + jal.al_terms(c, duals, pen, ineq), c

    J0, c0 = jax.vmap(jobj)(a["xs"], a["us"], a["ws"], a["duals"], a["pen"])
    J0, c0 = np.array(J0), np.array(c0)
    ref = jax.vmap(lambda xs, us, ws, K, k, s, J, c, d, p: jfw.line_search(
        jspec, lambda x_, u_: jobj(x_, u_, ws, d, p), xs, us, ws, K, k, s, J, c, jo,
        duals=d, penalty=p))(a["xs"], a["us"], a["ws"], a["K"], a["k"], slope, J0, c0,
                              a["duals"], a["pen"])

    def tobj(xs, us):
        J = dv.total_cost(tspec, xs, us, t(a["ws"]))
        c = dv.constraint_values(tspec, xs, us, t(a["ws"]))
        return J + al.al_terms(c, t(a["duals"]), t(a["pen"]), t(ineq)), c

    out = fw.line_search(tspec, tobj, t(a["xs"]), t(a["us"]), t(a["ws"]), t(a["K"]),
                         t(a["k"]), t(slope), t(J0), t(c0), to,
                         duals=t(a["duals"]), penalty=t(a["pen"]))
    names = ("xs", "us", "J", "c", "status", "step_size")
    for name, o, r in zip(names, out, ref):
        if name in ("status", "step_size"):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)
        else:
            close(o.numpy(), np.asarray(r))
    if not kw:
        assert 0 < int(out[4].sum()) < B          # some lanes accept, some fail
