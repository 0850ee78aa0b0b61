"""Port SL ops (iterativelqr_tpu_torch/ops/sl_ops.py) against the JAX
package's ``SLOps`` on the same acrobot arrays in f64: the AL objective,
the AL transition and the parallel-alpha line search."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import acrobot as jax_acrobot
from iterativelqr_tpu.ops.rollout import open_loop_rollout
from iterativelqr_tpu.ops.sl_ops import SLOps as JaxSLOps
from iterativelqr_tpu.ops.sl_ops import from_sl as jax_from_sl
from iterativelqr_tpu.ops.sl_ops import to_sl as jax_to_sl
from iterativelqr_tpu_torch import Options, build_spec
from iterativelqr_tpu_torch.models import acrobot
from iterativelqr_tpu_torch.ops.sl_ops import SLOps, from_sl, to_sl

torch.set_num_threads(1)

T, B = 9, 128   # the JAX SL layout needs B = S * 128
TOL = 1e-10

TUNED = dict(initial_constraint_penalty=1000.0, min_step_size=4e-3)


@pytest.fixture(scope="module")
def problem():
    jspec = jax_build_spec(*jax_acrobot.problem(T)[:3])
    tspec = build_spec(*acrobot.problem(T)[:3])
    rng = np.random.default_rng(7)
    x0 = 0.05 * rng.standard_normal((B, 4))
    us = 0.3 * rng.standard_normal((B, T - 1, 1))
    ws = np.zeros((B, T, 0))
    xs = np.asarray(jax.vmap(lambda x, u, w: open_loop_rollout(jspec, x, u, w))(
        jnp.asarray(x0), jnp.asarray(us), jnp.asarray(ws)))
    K = 0.1 * rng.standard_normal((B, T - 1, 1, 4))
    # per-lane step scales from tame to wild, so that some lanes accept in
    # the head block, some only in the tail and some not at all
    k = rng.standard_normal((B, T - 1, 1)) * np.logspace(-2, 3, B)[:, None, None]
    duals = 0.5 * rng.standard_normal((B, T, 4))
    penalty = np.full((B, T, 4), 10.0) * rng.uniform(0.5, 2.0, (B, 1, 1))
    slope = -np.abs(rng.standard_normal(B)) * np.logspace(0, 4, B)
    need = rng.uniform(size=B) < 0.8
    return dict(jspec=jspec, tspec=tspec, xs=xs, us=us, ws=ws, K=K, k=k,
                duals=duals, penalty=penalty, slope=slope, need=need)


def _j(a):
    return jax_to_sl(jnp.asarray(a), B // 128)


def _t(a):
    return to_sl(torch.as_tensor(a))


def _jnp(a):
    """JAX SL output -> batch-leading numpy."""
    return np.asarray(jax_from_sl(a))


def _tnp(a):
    return from_sl(a).numpy()


def _ops(p, **kw):
    return (JaxSLOps(p["jspec"], JaxOptions(record_traces=False, **kw)),
            SLOps(p["tspec"], Options(record_traces=False, **kw),
                  device="cpu", dtype=torch.float64))


def test_al_objective_matches(problem):
    p = problem
    jops, tops = _ops(p)
    args = ("xs", "us", "ws", "duals", "penalty")
    Jj, cj = jops.al_objective(*(_j(p[a]) for a in args))
    Jt, ct = tops.al_objective(*(_t(p[a]) for a in args))
    np.testing.assert_allclose(_tnp(Jt), _jnp(Jj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_tnp(ct), _jnp(cj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        _tnp(tops.max_violation(ct)), _jnp(jops.max_violation(cj)),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("truncated", ["none", "some"])
def test_al_transition_matches(problem, adaptive, truncated):
    p = problem
    jops, tops = _ops(p, adaptive_penalty=adaptive)
    rng = np.random.default_rng(3)
    c = 0.1 * rng.standard_normal((B, T, 4))
    viol = np.abs(c).max(axis=(1, 2))
    viol_prev = viol * rng.uniform(0.5, 8.0, B)
    trunc = rng.uniform(size=B) < 0.5
    jt = False if truncated == "none" else _j(trunc)
    tt = False if truncated == "none" else _t(trunc)
    dj, pj = jops.al_transition(_j(c), _j(viol), _j(p["duals"]),
                                _j(p["penalty"]), _j(viol_prev), jt)
    dt, pt = tops.al_transition(_t(c), _t(viol), _t(p["duals"]),
                                _t(p["penalty"]), _t(viol_prev), tt)
    np.testing.assert_allclose(_tnp(dt), _jnp(dj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_tnp(pt), _jnp(pj), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("grid", ["tuned8", "parity17", "none"])
@pytest.mark.parametrize("viol_filter", [False, True])
def test_line_search_matches(problem, grid, viol_filter):
    p = problem
    kw = dict(constraint_aware_acceptance=viol_filter)
    if grid == "tuned8":
        kw.update(TUNED)
    if grid == "none":
        kw["line_search"] = "none"
    jops, tops = _ops(p, **kw)
    names = ("xs", "us", "ws", "duals", "penalty")
    Jj, cj = jops.al_objective(*(_j(p[a]) for a in names))
    Jt, ct = tops.al_objective(*(_t(p[a]) for a in names))
    need = p["need"] if grid == "parity17" else None
    # the unconditional full step takes only tame steps: a full step of the
    # wild lanes diverges chaotically, where rounding differences grow
    k = p["k"] * (1e-3 if grid == "none" else 1.0)
    ref = jops.line_search(
        _j(p["xs"]), _j(p["us"]), _j(p["ws"]), _j(p["K"]), _j(k),
        _j(p["slope"]), Jj, cj, _j(p["duals"]), _j(p["penalty"]),
        need=None if need is None else _j(need),
    )
    out = tops.line_search(
        _t(p["xs"]), _t(p["us"]), _t(p["ws"]), _t(p["K"]), _t(k),
        _t(p["slope"]), Jt, ct, _t(p["duals"]), _t(p["penalty"]),
        need=None if need is None else _t(need),
    )
    for name, a, b in zip(["xs", "us", "J", "c", "status", "step"], ref, out):
        np.testing.assert_allclose(_tnp(b), _jnp(a), rtol=TOL, atol=TOL,
                                   err_msg=name)
    status, step = _tnp(out[4]), _tnp(out[5])
    if grid != "none":
        na = Options(**kw).num_step_sizes
        assert status.any() and not status.all()
        if na > 8:
            # some lane accepted only in the tail block
            assert (status & (step < 0.5 ** 7)).any()
