"""The port's associative Riccati scan (iterativelqr_tpu_torch/ops/assoc.py)
against the JAX package's functions on the same numpy inputs in f64; the
"auto" dispatch and the default single-instance solve it unlocks are in
tests/test_torch_assoc_solve.py.

Tolerance 1e-10 relative to the largest value: both sides are IEEE f64 and
compose the elements in the same tree (``jax.lax.associative_scan``'s
odd/even recursion, held bitwise by ``test_reverse_prefix_tree_matches_jax``),
summing the small products in other orders where XLA fuses its reductions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.ops import assoc as jassoc
from iterativelqr_tpu.ops import backward as jbw
from iterativelqr_tpu_torch import Options
from iterativelqr_tpu_torch.ops import assoc, backward

from test_torch_backward import close, stacks

torch.set_num_threads(1)


def lq(seed, B, T, n, m, padded):
    """Batch-leading random stacks with a per-lane reg; ``padded`` marks
    the last action invalid and zeroes its rows as spec padding does."""
    rng = np.random.default_rng(seed)
    st = stacks(rng, B, T - 1, n, m)
    um = np.ones((T - 1, m), bool)
    if padded:
        um[:, -1] = False
        fx, fu, gx, gu, gxx, guu, gux = st
        fu[..., :, -1] = 0.0
        gu[..., -1] = 0.0
        guu[..., -1, :] = 0.0
        guu[..., :, -1] = 0.0
        gux[..., -1, :] = 0.0
    reg = np.array([0.0, 1e-3, 0.5])[:B]
    return st, um, reg


# one compile a shape, shared by the full and padded cases (XLA's compile
# of the unrolled 12 x 12 solves takes about 20 s)
_jax_associative = jax.jit(jax.vmap(jassoc.backward_pass_associative,
                                    in_axes=(0,) * 7 + (None, 0)))


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("n,m", [(4, 1), (3, 2), (12, 4)])
def test_backward_pass_associative_matches_jax(n, m, padded):
    st, um, reg = lq(n + 10 * m, 3, 17 if n < 12 else 9, n, m, padded)
    ref = _jax_associative(*st, um, reg)
    out = assoc.backward_pass_associative(*(torch.as_tensor(a) for a in st),
                                          torch.as_tensor(um), torch.as_tensor(reg))
    for a, b in zip(out, ref):
        close(a, b)
    assert np.asarray(ref[5]).all()
    # one instance, no lane axis
    one = assoc.backward_pass_associative(*(torch.as_tensor(a[1]) for a in st),
                                          torch.as_tensor(um), torch.as_tensor(reg[1]))
    for a, b in zip(one, ref):
        close(a, np.asarray(b)[1])
    if padded:
        assert not out[0][..., -1, :].any() and not out[1][..., -1].any()


def element(seed, n, m):
    """One stage element of the port and of JAX, from the same stacks."""
    st, um, reg = lq(seed, 1, 2, n, m, False)
    args = [a[0, 0] for a in st[:2]] + [st[2][0, 0], st[3][0, 0], st[4][0, 0],
                                        st[5][0, 0], st[6][0, 0]]
    jel, _ = jassoc._make_element(*args, jnp.asarray(um[0], jnp.float64), 0.0)
    # the port's elements carry a time axis
    tel, _ = assoc._make_element(*(torch.as_tensor(a)[None] for a in args),
                                 torch.as_tensor(um[:1], dtype=torch.float64),
                                 torch.zeros((), dtype=torch.float64))
    return tuple(a[0] for a in tel), jel


@pytest.mark.parametrize("side", ["left", "right"])
def test_combine_with_identity(side):
    """``identity_element`` on either side of ``_combine`` leaves the other
    element unchanged; the composition of two elements matches JAX's."""
    n, m = 4, 2
    (tel, jel), (tel2, jel2) = element(1, n, m), element(2, n, m)
    for a, b in zip(tel, jel):
        close(a, b)
    ident = assoc.identity_element(n, torch.float64)
    pair = (ident, tel) if side == "left" else (tel, ident)
    for a, b in zip(assoc._combine(*pair), tel):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-14)
    jpair = (jel, jel2) if side == "left" else (jel2, jel)
    tpair = (tel, tel2) if side == "left" else (tel2, tel)
    for a, b in zip(assoc._combine(*tpair), jassoc._combine(*jpair)):
        close(a, b)


@pytest.mark.parametrize("mode", ["unbatched", "associative"])
def test_one_instance_backward_matches_jax(mode):
    """The per-instance form: "auto" takes the associative scan unbatched,
    and backward_pass="associative" takes it on any batch."""
    st, um, _ = lq(11, 3, 13, 3, 2, False)
    reg = np.zeros(3)
    if mode == "unbatched":
        out = backward.backward_pass(*(torch.as_tensor(a[:1]) for a in st),
                                     torch.as_tensor(um), torch.as_tensor(reg[:1]),
                                     Options(), batched=False)
        ref = jbw.backward_pass(*(a[0] for a in st), um, reg[0], JaxOptions())
        ref = [np.asarray(r)[None] for r in ref]
    else:
        opts = dict(backward_pass="associative")
        out = backward.backward_pass(*(torch.as_tensor(a) for a in st), torch.as_tensor(um),
                                     torch.as_tensor(reg), Options(**opts))
        ref = jax.vmap(lambda *a: jbw.backward_pass(*a[:7], um, a[7], JaxOptions(**opts)))(
            *st, reg)
    for a, b in zip(out, ref):
        close(a, b)


def test_reverse_prefix_tree_matches_jax():
    """The composition tree of ``_reverse_prefix`` is the one of
    ``jax.lax.associative_scan(..., reverse=True)``: with a non-commutative
    operator of rounded products the prefixes agree bitwise at every
    length."""
    rng = np.random.default_rng(0)
    flip = lambda ps: tuple(a.flip(a.ndim - 1 - r) for a, r in zip(ps, assoc._RANKS))
    # products round differently in another tree; a - 2 b (one rounding,
    # whether or not fused) tells the operands apart
    for op in (lambda a, b: a * b, lambda a, b: a - 2.0 * b):
        scan = jax.jit(lambda v: jax.lax.associative_scan(op, v, reverse=True, axis=1))
        for T in range(1, 24):
            v = rng.uniform(0.5, 1.5, size=(3, T))
            ref = np.asarray(scan(jnp.asarray(v)))
            parts = tuple(torch.as_tensor(v).reshape((3, T) + (1,) * r) for r in assoc._RANKS)
            out = flip(assoc._scan(lambda a, b: tuple(map(op, a, b)), flip(parts)))
            for a in out:
                np.testing.assert_array_equal(a.reshape(3, T).numpy(), ref)
