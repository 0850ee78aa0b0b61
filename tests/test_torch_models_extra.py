"""The port's particle, pendulum and cartpole models (iterativelqr_tpu_torch/
models/{particle,pendulum,cartpole}.py) against the JAX package's: stage
functions and derivative stacks (dynamics, their second derivatives,
costs, constraints) per t and per lane at random points, to 1e-12 (the same
f64 operations); the committed particle and cartpole goldens through the
port's SL solver on the CPU, held to tests/test_golden.py's gates; and the
particle through the vmap route with the "auto" backward against
``jax.vmap(make_solve_fn)``, whose rule maps particle's constant fx/fu
unbatched where the port batches every stack: equal iterations per lane,
xs within 1e-10 of their largest value."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu import make_solve_fn as jax_make_solve_fn
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import cartpole as jax_cartpole
from iterativelqr_tpu.models import particle as jax_particle
from iterativelqr_tpu.models import pendulum as jax_pendulum
from iterativelqr_tpu_torch import Options, build_spec, make_batched_solve_fn, make_solve_fn
from iterativelqr_tpu_torch.models import cartpole, particle, pendulum
from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk
from iterativelqr_tpu_torch.ops.rollout import open_loop_rollout
from test_torch_spec import _cmp, _jax_eval, _torch_eval

torch.set_num_threads(1)

_FIX = os.path.join(os.path.dirname(__file__), "fixtures")
_MODELS = {"particle": (jax_particle, particle), "pendulum": (jax_pendulum, pendulum),
           "cartpole": (jax_cartpole, cartpole)}
T, B = 9, 6


def _specs(name, T, **kw):
    jmod, tmod = _MODELS[name]
    return (jax_build_spec(*jmod.problem(T, **kw)[:3]),
            build_spec(*tmod.problem(T, **kw, device="cpu")[:3]))


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_stage_functions_and_stacks_match_jax(name):
    """Every stage family per t and lane (cartpole with non-default
    u_limit and shaping_weight, controls on both sides of the limit), the
    spec's layout, x1 and xT, and the rollout kernels' registry entry."""
    kw = dict(u_limit=4.0, shaping_weight=3.0) if name == "cartpole" else {}
    jspec, tspec = _specs(name, T, **kw)
    for f in ("T", "nx", "nu", "nc", "npar"):
        assert getattr(tspec, f) == getattr(jspec, f), f
    for f in ("dyn_tidx", "cost_tidx", "con_tidx", "c_mask", "ineq_mask"):
        np.testing.assert_array_equal(getattr(tspec, f), getattr(jspec, f))
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((B, T, tspec.nx))
    us = 5.0 * rng.standard_normal((B, T, tspec.nu))
    ws = np.zeros((B, T, 0))
    families = {"dyn": ("dyn_eval", "dyn_jac", "dyn_hess"),
                "cost": ("cost_eval", "cost_grad", "cost_hess"),
                "con": ("con_eval", "con_jac")}
    for fam, names in families.items():
        for k, rows in enumerate(getattr(jspec, f"{fam}_groups")):
            for f in names:
                _cmp(_jax_eval(getattr(jspec, f)[k], rows, xs, us, ws),
                     _torch_eval(getattr(tspec, f)[k], rows, xs, us, ws))
    jmod, tmod = _MODELS[name]
    for a, b in zip(jmod.problem(T, **kw)[3:], tmod.problem(T, **kw, device="cpu")[3:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    m = fk.device_model(tspec)
    assert m.name == name
    assert m.params == {"particle": (1.0, 0.0), "pendulum": (), "cartpole": (4.0, 3.0)}[name]
    if name == "cartpole":
        np.testing.assert_array_equal(cartpole.swingup_controls(T),
                                      jax_cartpole.swingup_controls(T))


@pytest.mark.parametrize("name,gates", [("particle", (1e-6, 1e-6)), ("cartpole", (1e-2, 5e-2))])
def test_golden_through_the_sl_solver(name, gates):
    """tests/fixtures/golden_{name}.npz through the port's SL batched solver
    on one lane, f64, with the reference-exact AL schedule the fixtures
    were made with: violation <= 5e-3, xs and us within the gates of
    tests/test_golden.py."""
    data = np.load(os.path.join(_FIX, f"golden_{name}.npz"))
    Tg = data["xs"].shape[0]
    _, tmod = _MODELS[name]
    dyn, cost, con, x1, _ = tmod.problem(Tg, device="cpu")
    spec = build_spec(dyn, cost, con)
    us = torch.as_tensor(data["us0"])[None]
    ws = torch.zeros((1, Tg, 0), dtype=torch.float64)
    xs = open_loop_rollout(spec, x1[None], us, ws)
    sol = make_batched_solve_fn(spec, Options(record_traces=False, adaptive_penalty=False),
                                device="cpu", dtype=torch.float64)(xs, us, ws)
    x_atol, u_atol = gates
    assert float(sol.max_violation[0]) <= 5e-3
    np.testing.assert_allclose(sol.xs[0].numpy(), data["xs"], atol=x_atol)
    np.testing.assert_allclose(sol.us[0].numpy(), data["us"], atol=u_atol)


def test_particle_vmap_route_matches_jax():
    """Particle T=11, B=4, the literal Options() (traces on: the vmap
    route; "auto" backward: at B=4 > T // 7 the reverse scan), x0 = x1 +
    0.3 N(0,1) from numpy seed 0, controls 0.05, states rolled out."""
    Tp, Bp = 11, 4
    jspec, tspec = _specs("particle", Tp)
    rng = np.random.default_rng(0)
    xs = np.zeros((Bp, Tp, 2))
    xs[:, 0] = 0.3 * rng.standard_normal((Bp, 2))
    us = np.full((Bp, Tp - 1, 1), 0.05)
    ws = np.zeros((Bp, Tp, 0))
    ref = jax.jit(jax.vmap(jax_make_solve_fn(jspec, JaxOptions())))(
        *(jnp.asarray(a) for a in (xs, us, ws)))
    sol = make_solve_fn(tspec, Options(), device="cpu").vmap()(
        *(torch.as_tensor(a) for a in (xs, us, ws)))
    for f in ("iterations", "al_iterations", "status"):
        np.testing.assert_array_equal(getattr(sol, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    want = np.asarray(ref.xs)
    np.testing.assert_allclose(sol.xs.numpy(), want, rtol=0,
                               atol=1e-10 * max(np.abs(want).max(), 1.0))
