"""The generated device functions' new op families
(iterativelqr_tpu_torch/ops/device_functions.py) against what the JAX
package's kernel body runs, in f64 on the CPU: for each family, a torch
stage function's scalar program (``df.run`` of ``df.trace``) and JAX's
``_eval_jaxpr_no_dot`` (iterativelqr_tpu/ops/sl_forward_kernel.py) on
``jax.make_jaxpr`` of its jnp counterpart, on the same numpy inputs, agree
within 1e-12 relative.  No Pallas compile: ``_eval_jaxpr_no_dot`` is the
evaluator the Pallas body calls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import erf as jerf

from iterativelqr_tpu.ops.sl_forward_kernel import _eval_jaxpr_no_dot
from iterativelqr_tpu_torch.ops import device_functions as df

torch.set_num_threads(1)

TOL = 1e-12
_rng = np.random.default_rng(21)
A = _rng.standard_normal((3, 3))
Q = np.diag([1.0, 0.5, 2.0]) + 0.1
IDX = np.array([2, 0, 2])
tA, tQ, tIDX = torch.as_tensor(A), torch.as_tensor(Q), torch.as_tensor(IDX)


def _t_writes(x, u, w):
    z = torch.zeros_like(x)
    z[1] = u[0]
    z[0:2] += w
    return torch.cat([z, x.new_zeros(3).index_put((tIDX[:2],), u), torch.eye(3, dtype=x.dtype) @ x])


def _j_writes(x, u, w):
    z = jnp.zeros_like(x).at[1].set(u[0])
    z = z.at[0:2].add(w)
    return jnp.concatenate([z, jnp.zeros(3).at[IDX[:2]].set(u), jnp.eye(3) @ x])


# family -> (torch function, jnp function), both of (x [3], u [2], w [2])
FAMILIES = {
    "products": (
        lambda x, u, w: torch.cat([(x @ tQ @ x).reshape(1), x @ tA, tA.T @ x,
                                   torch.einsum("ij,j->i", tA, x),
                                   torch.linalg.cross(x, tA @ x), torch.outer(u, w).sum(0)]),
        lambda x, u, w: jnp.concatenate([(x @ Q @ x).reshape(1), x @ A, A.T @ x,
                                         jnp.einsum("ij,j->i", A, x), jnp.cross(x, A @ x),
                                         jnp.outer(u, w).sum(0)])),
    "layout": (
        lambda x, u, w: torch.cat([x[0].expand(3) + x, u.repeat(2), x.flip(0),
                                   torch.diagonal(tA) * x, tA.t()[1] * x,
                                   torch.stack([x.unbind()[2], x.unbind()[0]])]),
        lambda x, u, w: jnp.concatenate([jnp.broadcast_to(x[0], (3,)) + x, jnp.tile(u, 2),
                                         jnp.flip(x), jnp.diagonal(A) * x, A.T[1] * x,
                                         jnp.stack([x[2], x[0]])])),
    "constant indices": (
        lambda x, u, w: torch.cat([x[tIDX], x[[0, 2]], torch.index_select(x, 0, tIDX),
                                   torch.gather(x, 0, tIDX), (tA * x)[:, tIDX][1]]),
        lambda x, u, w: jnp.concatenate([x[IDX], x[np.array([0, 2])], jnp.take(x, IDX),
                                         x[IDX], (A * x)[:, IDX][1]])),
    "writes": (_t_writes, _j_writes),
    "unary math": (
        lambda x, u, w: torch.cat([
            torch.atan2(x, 1.0 + x * x), torch.atan(x), torch.asin(0.9 * torch.tanh(x)),
            torch.acos(0.5 * torch.tanh(x)), torch.sinh(x), torch.cosh(x), torch.asinh(x),
            torch.acosh(1.5 + x * x), torch.atanh(0.5 * torch.tanh(x)), torch.sigmoid(x),
            torch.nn.functional.softplus(x), torch.log1p(x * x), torch.expm1(x),
            torch.rsqrt(1.0 + x * x), torch.reciprocal(2.0 + x), torch.sign(x), torch.erf(x),
            torch.relu(x), torch.hypot(x, u[0]), (1.0 + x * x) ** 2.5]),
        lambda x, u, w: jnp.concatenate([
            jnp.arctan2(x, 1.0 + x * x), jnp.arctan(x), jnp.arcsin(0.9 * jnp.tanh(x)),
            jnp.arccos(0.5 * jnp.tanh(x)), jnp.sinh(x), jnp.cosh(x), jnp.arcsinh(x),
            jnp.arccosh(1.5 + x * x), jnp.arctanh(0.5 * jnp.tanh(x)), jax.nn.sigmoid(x),
            jax.nn.softplus(x), jnp.log1p(x * x), jnp.expm1(x),
            jax.lax.rsqrt(1.0 + x * x), jnp.reciprocal(2.0 + x), jnp.sign(x), jerf(x),
            jax.nn.relu(x), jnp.hypot(x, u[0]), (1.0 + x * x) ** 2.5])),
    "reductions": (
        lambda x, u, w: torch.cat([
            torch.stack([torch.max(x), torch.min(x), torch.prod(x), torch.mean(x),
                         torch.linalg.vector_norm(x), torch.linalg.vector_norm(x, 1),
                         torch.linalg.vector_norm(x, float("inf"))]),
            torch.amax(tA * x, 1), torch.amin(tA * x, 0), torch.max(tA * x, 1).values]),
        lambda x, u, w: jnp.concatenate([
            jnp.stack([jnp.max(x), jnp.min(x), jnp.prod(x), jnp.mean(x), jnp.linalg.norm(x),
                       jnp.linalg.norm(x, 1), jnp.linalg.norm(x, jnp.inf)]),
            jnp.max(A * x, 1), jnp.min(A * x, 0), jnp.max(A * x, 1)])),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_equals_jax_kernel_evaluator(family):
    tfn, jfn = FAMILIES[family]
    prog = df.trace(tfn, 3, 2, 2)
    rng = np.random.default_rng(22)
    B = 4
    x, u, w = (rng.standard_normal((n, B)) for n in (3, 2, 2))
    got = df.run(prog, *(torch.as_tensor(a) for a in (x, u, w))).numpy()
    for b in range(B):
        args = [jnp.asarray(a[:, b]) for a in (x, u, w)]
        closed = jax.make_jaxpr(jfn)(*args)
        want = np.asarray(_eval_jaxpr_no_dot(closed.jaxpr, closed.consts, *args)[0])
        scale = np.maximum(np.abs(want), 1.0)
        assert np.all(np.abs(got[:, b] - want) <= TOL * scale), (family, b, got[:, b], want)
