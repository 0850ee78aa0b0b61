"""The port's fused derivative pass ``ops/derivatives.py::
stage_derivatives`` against the JAX package's
(``iterativelqr_tpu/ops/derivatives.py::stage_derivatives``) and against
the port's separate stacks, as tests/test_derivatives.py::
test_stage_derivatives_matches_separate_stacks holds JAX's: a problem with
two dynamics and two cost stage types along T=9, f64, random numpy
inputs; also with two leading lane axes (the per-instance solver's batched
form)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativelqr_tpu as jilqr
import iterativelqr_tpu_torch as P
from iterativelqr_tpu.ops import derivatives as jdv
from iterativelqr_tpu_torch.ops import derivatives as dv

torch.set_num_threads(1)

T = 9
NAMES = ("fx", "fu", "gx", "gu", "gxx", "guu", "gux")


def _problem(pkg, xp):
    A = xp.asarray([[1.0, 0.3], [0.0, 1.0]], dtype=xp.float64)
    b1 = xp.asarray([0.0, 0.3], dtype=xp.float64)
    b2 = xp.asarray([0.1, 0.5], dtype=xp.float64)
    d1 = pkg.Dynamics(lambda x, u: A @ x + b1 * u[0], 2, 1)
    d2 = pkg.Dynamics(lambda x, u: A @ x + b2 * xp.tanh(u[0]), 2, 1)
    g1 = pkg.Cost(lambda x, u: 0.1 * (x @ x + u @ u), 2, 1)
    g2 = pkg.Cost(lambda x, u: 0.3 * xp.sum(xp.cosh(x)) + 0.2 * u @ u, 2, 1)
    gT = pkg.Cost(lambda x, u: 0.5 * (x @ x), 2, 0)
    dynamics = [d1 if t % 2 == 0 else d2 for t in range(T - 1)]
    costs = [g1 if t % 3 == 0 else g2 for t in range(T - 1)] + [gT]
    return pkg.build_spec(dynamics, costs)


@pytest.mark.parametrize("lanes", [(), (2, 3)])
def test_stage_derivatives_matches_jax_and_separate_stacks(lanes):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal(lanes + (T, 2))
    us = 0.3 * rng.standard_normal(lanes + (T - 1, 1))
    ws = np.zeros(lanes + (T, 0))
    spec = _problem(P, torch)
    tin = [torch.as_tensor(a) for a in (xs, us, ws)]
    fused = dv.stage_derivatives(spec, *tin)
    separate = (*dv.dynamics_jacobians(spec, *tin), *dv.cost_gradients(spec, *tin),
                *dv.cost_hessians(spec, *tin))
    jspec = _problem(jilqr, jnp)
    for name, got, want in zip(NAMES, fused, separate):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    # the JAX pass on every lane at once (jax.vmap over the flattened lanes)
    n = int(np.prod(lanes))
    flat = [jnp.asarray(a.reshape((n,) + a.shape[len(lanes):])) for a in (xs, us, ws)]
    jfused = jax.jit(jax.vmap(lambda x, u, w: jdv.stage_derivatives(jspec, x, u, w)))(*flat)
    for name, got, want in zip(NAMES, fused, jfused):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
