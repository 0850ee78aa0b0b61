"""The per-instance solver's vmap route of the port (core/solve.py::
make_solve_fn(...).vmap, and make_batched_solve_fn for options the SL solver
does not take) against the JAX package's ``jax.vmap(make_solve_fn(...))`` on
the same numpy inputs, f64: acrobot T=9 and car T=12, B=4.  The helpers
here serve tests/test_torch_solve_{loops,dispatch,packed}.py too.

Equal per lane: iterations, AL iterations, line-search status and the
trace masks.  Trajectories within 1e-10 of their largest value; objective
and violation within 1e-8; gains, gradient norms, duals, penalties, step
sizes and trace values within 1e-6 of their largest value (they are read
off ill-conditioned intermediate iterates, where f64 rounding in another
summation order grows by up to about 1e4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu import make_solve_fn as jax_make_solve_fn
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import acrobot as jax_acrobot
from iterativelqr_tpu.models import car as jax_car
from iterativelqr_tpu.ops.rollout import open_loop_rollout
from iterativelqr_tpu.parallel.batch import make_batched_solve_fn as jax_make_batched
from iterativelqr_tpu_torch import Options, build_spec, make_batched_solve_fn, make_solve_fn
from iterativelqr_tpu_torch.convert import solution_to_numpy
from iterativelqr_tpu_torch.models import acrobot, car

torch.set_num_threads(1)

B = 4
# 12 iterations a round, 3 rounds: the literal Options() cases run uncut
BASE = dict(max_iterations=12, max_dual_updates=3)


@functools.lru_cache(maxsize=None)
def inputs(model):
    """(jax spec, port spec, xs, us, ws): states rolled out open loop from
    perturbed initial states and the model's initial controls."""
    T = {"acrobot": 9, "car": 12}[model]
    jm, tm = {"acrobot": (jax_acrobot, acrobot), "car": (jax_car, car)}[model]
    jspec = jax_build_spec(*jm.problem(T)[:3])
    rng = np.random.default_rng(3)
    if model == "acrobot":
        x0 = 0.02 * rng.standard_normal((B, 4))
        us = np.full((B, T - 1, 1), 0.05)
    else:
        x0 = np.asarray(jm.problem(T)[3]) + 0.02 * rng.standard_normal((B, 3))
        us = np.broadcast_to(np.asarray(jm.initial_controls(T)), (B, T - 1, 2)).copy()
    ws = np.zeros((B, T, 0))
    xs = np.array(jax.vmap(lambda x, u, w: open_loop_rollout(jspec, x, u, w))(
        jnp.asarray(x0), jnp.asarray(us), jnp.asarray(ws)))
    return jspec, build_spec(*tm.problem(T)[:3]), xs, us, ws


def jax_solve(model, opts, *extra, in_axes=0, **kw):
    jspec, _, xs, us, ws = inputs(model)
    fn = jax.jit(jax.vmap(jax_make_solve_fn(jspec, JaxOptions(**opts), **kw),
                          in_axes=in_axes))
    args = [xs, us, ws, *extra]
    if in_axes != 0:
        args = [a if ax == 0 else a[0] for a, ax in zip(args, in_axes)]
    return {k: np.asarray(v) for k, v in vars(fn(*(jnp.asarray(a) for a in args))).items()}


def port_solve(model, opts, *extra, in_axes=0, **kw):
    _, tspec, xs, us, ws = inputs(model)
    args = [torch.as_tensor(a) for a in (xs, us, ws, *extra)]
    if in_axes != 0:
        args = [a if ax == 0 else a[0] for a, ax in zip(args, in_axes)]
    sol = make_solve_fn(tspec, Options(**opts), device="cpu", **kw).vmap(in_axes)(*args)
    return solution_to_numpy(sol)


def assert_matches(out, ref):
    for name in ("iterations", "al_iterations", "status", "trace_mask"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    tols = dict(xs=1e-10, us=1e-10, objective=1e-8, max_violation=1e-8)
    for name, b in ref.items():
        if name in ("iterations", "al_iterations", "status", "trace_mask"):
            continue
        a = out[name]
        assert a.shape == b.shape, name
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=name)
        scale = max(np.abs(b[fin]).max(), 1e-300) if fin.any() else 1.0
        np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                   atol=tols.get(name, 1e-6) * scale, err_msg=name)


@pytest.mark.parametrize("model", ["acrobot", "car"])
def test_literal_options_match_jax(model):
    """make_batched_solve_fn(spec, Options()): traces on, so not the SL
    solver; the "auto" backward takes the reverse scan at B=4."""
    jspec, tspec, xs, us, ws = inputs(model)
    ref = jax_make_batched(jspec, JaxOptions())(*(jnp.asarray(a) for a in (xs, us, ws)))
    ref = {k: np.asarray(v) for k, v in vars(ref).items()}
    sol = make_batched_solve_fn(tspec, Options(), device="cpu", dtype=torch.float64)(
        *(torch.as_tensor(a) for a in (xs, us, ws)))
    out = solution_to_numpy(sol)
    assert_matches(out, ref)
    # every iteration left one trace entry (no round was truncated)
    np.testing.assert_array_equal(out["trace_mask"].sum(axis=(1, 2)), out["iterations"])


def test_shared_argument_in_axes_matches_jax():
    """in_axes=(0, 0, None): one parameter trajectory for every lane."""
    axes = (0, 0, None)
    assert_matches(port_solve("acrobot", BASE, in_axes=axes),
                   jax_solve("acrobot", BASE, in_axes=axes))


def test_one_instance_matches_jax():
    """The per-instance form, with the reverse-scan backward."""
    jspec, tspec, xs, us, ws = inputs("car")
    opts = dict(BASE, backward_pass="scan")
    ref = jax.jit(jax_make_solve_fn(jspec, JaxOptions(**opts)))(
        *(jnp.asarray(a[1]) for a in (xs, us, ws)))
    sol = make_solve_fn(tspec, Options(**opts), device="cpu")(
        *(torch.as_tensor(a[1]) for a in (xs, us, ws)))
    out = solution_to_numpy(sol)
    assert out["xs"].shape == xs.shape[1:]
    assert_matches({k: v[None] for k, v in out.items()},
                   {k: np.asarray(v)[None] for k, v in vars(ref).items()})


def test_solver_for_the_card_refuses_cpu_tensors():
    _, tspec, xs, us, ws = inputs("acrobot")
    solve = make_solve_fn(tspec, Options(backward_pass="scan"))
    with pytest.raises(ValueError, match="built for cuda"):
        solve.vmap()(*(torch.as_tensor(a) for a in (xs, us, ws)))
