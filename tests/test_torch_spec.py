"""Port problem spec (iterativelqr_tpu_torch/core/spec.py + models/acrobot.py)
against the JAX package: acrobot derivative stacks per t and per lane, the
terminal num_action=0 stage included, and the manual-derivative escape hatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import acrobot as jax_acrobot
from iterativelqr_tpu_torch import Constraint, Cost, Dynamics, build_spec
from iterativelqr_tpu_torch.models import acrobot
from iterativelqr_tpu_torch.ops.derivatives import constraint_values
from iterativelqr_tpu_torch.ops.packed_pipeline import _grouped_bt2

torch.set_num_threads(1)

T, B = 21, 8
ATOL = 1e-12


@pytest.fixture(scope="module")
def specs():
    jspec = jax_build_spec(*jax_acrobot.problem(T)[:3])
    tspec = build_spec(*acrobot.problem(T)[:3])
    return jspec, tspec


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((B, T, 4))
    us = rng.standard_normal((B, T, 1))   # row T-1 feeds the terminal stage
    us[:, -1] = 0.0
    ws = np.zeros((B, T, 0))
    return xs, us, ws


def _jax_eval(fn, rows, xs, us, ws):
    """fn over lanes x the given timesteps -> numpy, [B, len(rows), ...]."""
    f = jax.jit(jax.vmap(jax.vmap(fn)))
    out = f(jnp.asarray(xs[:, rows]), jnp.asarray(us[:, rows]),
            jnp.asarray(ws[:, rows]))
    return jax.tree.map(np.asarray, out)


def _torch_eval(fn, rows, xs, us, ws):
    f = vmap(vmap(fn))
    t = lambda a: torch.as_tensor(a[:, rows], dtype=torch.float64)
    out = f(t(xs), t(us), t(ws))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _cmp(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=0, atol=ATOL)
    else:
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)


def test_spec_layout_matches(specs):
    jspec, tspec = specs
    for name in ("T", "nx", "nu", "nc", "npar"):
        assert getattr(tspec, name) == getattr(jspec, name)
    for name in ("dyn_tidx", "cost_tidx", "con_tidx", "x_dims", "u_dims",
                 "c_dims", "x_mask", "u_mask", "c_mask", "ineq_mask"):
        np.testing.assert_array_equal(getattr(tspec, name), getattr(jspec, name))


@pytest.mark.parametrize("family", [
    "dyn_eval", "dyn_jac", "cost_eval", "cost_grad", "cost_hess",
    "con_eval", "con_jac",
])
def test_stage_functions_match_per_t_and_lane(specs, batch, family):
    """Every stage type over its own timesteps: fx, fu (dyn_jac); gx, gu
    (cost_grad); gxx, guu, gux (cost_hess); cx, cu (con_jac)."""
    jspec, tspec = specs
    xs, us, ws = batch
    kind = family.split("_")[0]
    groups = {"dyn": jspec.dyn_groups, "cost": jspec.cost_groups,
              "con": jspec.con_groups}[kind]
    for k, rows in enumerate(groups):
        a = _jax_eval(getattr(jspec, family)[k], rows, xs, us, ws)
        b = _torch_eval(getattr(tspec, family)[k], rows, xs, us, ws)
        _cmp(a, b)


def test_terminal_stage_action_derivatives_are_exact_zeros(specs, batch):
    """The terminal cost and constraint have num_action=0 (u[:0] is empty):
    their action derivatives must be exact zeros of the padded width."""
    _, tspec = specs
    xs, us, ws = batch
    x = torch.as_tensor(xs[0, -1])
    u = torch.as_tensor(np.array([0.7]))
    w = torch.zeros(0, dtype=torch.float64)
    gT = int(tspec.cost_tidx[-1])
    cT = int(tspec.con_tidx[-1])
    gx, gu = tspec.cost_grad[gT](x, u, w)
    gxx, guu, gux = tspec.cost_hess[gT](x, u, w)
    cx, cu = tspec.con_jac[cT](x, u, w)
    for a, shape in ((gu, (1,)), (guu, (1, 1)), (gux, (1, 4)), (cu, (4, 1))):
        assert tuple(a.shape) == shape
        assert torch.count_nonzero(a) == 0
    assert torch.count_nonzero(gx) > 0 and torch.count_nonzero(cx) > 0


def test_constraint_values_match(specs, batch):
    from iterativelqr_tpu.ops.derivatives import constraint_values as jax_cv

    jspec, tspec = specs
    xs, us, ws = batch
    a = np.asarray(jax.vmap(lambda x, u, w: jax_cv(jspec, x, u, w))(
        jnp.asarray(xs), jnp.asarray(us[:, :-1]), jnp.asarray(ws)))
    t = lambda v: torch.as_tensor(v, dtype=torch.float64)
    b = vmap(lambda x, u, w: constraint_values(tspec, x, u, w))(
        t(xs), t(us[:, :-1]), t(ws)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)


def test_grouped_bt2_merges_stage_types_in_time_order():
    """Two cost types interleaved over t: the batch-last grouped evaluation
    equals evaluating each timestep with its own function."""
    f1 = lambda x, u, w: 0.5 * torch.dot(x, x) + torch.dot(u, u)
    f2 = lambda x, u, w: torch.sum(torch.sin(x)) * u[0]
    fns = {0: f1, 1: f2}
    key = np.array([0, 1, 1, 0, 1, 0])
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((6, 3, 5)))
    u = torch.as_tensor(rng.standard_normal((6, 2, 5)))
    w = torch.zeros((6, 0, 5), dtype=torch.float64)
    out = _grouped_bt2(fns, key, 6, (x, u, w))
    for t in range(6):
        for b in range(5):
            ref = fns[int(key[t])](x[t, :, b], u[t, :, b], w[t, :, b])
            assert torch.allclose(out[t, b], ref, rtol=0, atol=1e-14)


def test_manual_derivatives_escape_hatch():
    """Manual Jacobians / cost derivatives replace autodiff and agree
    with it where they are correct."""
    A = torch.tensor([[1.0, 0.1], [0.0, 1.0]], dtype=torch.float64)
    Bm = torch.tensor([[0.0], [0.1]], dtype=torch.float64)
    f = lambda x, u: A @ x + Bm @ u
    auto = Dynamics(f, 2, 1)
    manual = Dynamics(f, 2, 1, jacobian_state=lambda x, u: A,
                      jacobian_action=lambda x, u: Bm)
    g = lambda x, u: 0.5 * torch.dot(x, x) + torch.dot(u, u)
    cost_m = Cost(
        g, 2, 1,
        gradient_state=lambda x, u: x, gradient_action=lambda x, u: 2.0 * u,
        hessian_state_state=lambda x, u: torch.eye(2, dtype=x.dtype),
        hessian_action_action=lambda x, u: 2.0 * torch.eye(1, dtype=x.dtype),
        hessian_action_state=lambda x, u: torch.zeros(1, 2, dtype=x.dtype),
    )
    sa = build_spec([auto] * 2, [Cost(g, 2, 1)] * 2 + [Cost(g, 2, 0)])
    sm = build_spec([manual] * 2, [cost_m] * 2 + [Cost(g, 2, 0)])
    x = torch.tensor([0.3, -0.2], dtype=torch.float64)
    u = torch.tensor([0.5], dtype=torch.float64)
    w = torch.zeros(0, dtype=torch.float64)
    for a, b in zip(sa.dyn_jac[0](x, u, w), sm.dyn_jac[0](x, u, w)):
        assert torch.allclose(a, b, rtol=0, atol=1e-15)
    for a, b in zip(sa.cost_grad[0](x, u, w), sm.cost_grad[0](x, u, w)):
        assert torch.allclose(a, b, rtol=0, atol=1e-15)
    for a, b in zip(sa.cost_hess[0](x, u, w), sm.cost_hess[0](x, u, w)):
        assert torch.allclose(a, b, rtol=0, atol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_derivatives_keep_the_input_dtype(specs, dtype):
    """float32 in, float32 out: the CUDA kernel takes one dtype, and forward
    mode may otherwise carry a Python-float product's tangent in float64."""
    _, tspec = specs
    x = torch.full((4,), 0.3, dtype=dtype)
    u = torch.full((1,), 0.1, dtype=dtype)
    w = torch.zeros(0, dtype=dtype)
    outs = (tspec.dyn_jac[0](x, u, w) + tspec.cost_grad[0](x, u, w)
            + tspec.cost_hess[0](x, u, w) + tspec.con_jac[1](x, u, w))
    assert all(o.dtype == dtype for o in outs)


def test_sizes_are_probed_without_running_on_the_constants_device():
    """Dynamics and Constraint find their output sizes on fake tensors, as
    the JAX package's ``eval_shape``: closed-over constants on another
    device than the CPU (``meta`` stands in for the card here) need no
    ``num_next_state`` or ``num_constraint``; a branch on a value still
    probes on CPU zeros."""
    Q = torch.eye(3, dtype=torch.float64, device="meta")
    idx = torch.tensor([0, 2], device="meta")
    dyn = Dynamics(lambda x, u: torch.cat([x @ Q, u]), 3, 2)
    con = Constraint(lambda x, u: torch.cat([x[idx], torch.linalg.vector_norm(u).reshape(1)]),
                     3, 2, indices_inequality=(2,))
    branch = Dynamics(lambda x, u: x if float(u[0]) > 0 else torch.cat([x, u]), 3, 2)
    assert (dyn.num_next_state, con.num_constraint, branch.num_next_state) == (5, 3, 5)
