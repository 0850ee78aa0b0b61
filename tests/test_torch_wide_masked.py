"""Port K5, K6a and K6b at the quadrotor's wide dims (n=12, m=4), where the
card runs them on K2's recursion template, against the JAX package's Pallas
kernels ``backward_pass_batched_pallas_v3``, ``backward_pass_batched_pallas``
(v1) and ``_v2`` in interpret mode, and ``make_backward_dispatch`` batched
at those dims against JAX's vmapped dispatch; in f64 from numpy seeds, at a
short horizon (T=6) and the lane blocks of tests/test_torch_pallas_backward.py.

On the CPU the port's wrappers take their plain PyTorch versions (the CUDA
kernels are held against those on the card by tests/test_torch_cuda.py and
chip_smoke.py).  Tolerance 1e-10 relative to the largest value: both sides
are IEEE f64 and sum the same products in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu.ops import packed_backward as jpk
from iterativelqr_tpu.ops import pallas_backward as jpb
from iterativelqr_tpu_torch.ops import packed_backward as pk
from iterativelqr_tpu_torch.ops import pallas_backward as pb
from iterativelqr_tpu_torch.ops.batching import lane_call

from test_torch_backward import close, stacks

torch.set_num_threads(1)

T, N, M = 6, 12, 4


def _case(B, seed, zero_masked):
    """Stacks with the last action dim masked; ``zero_masked`` zeroes its
    derivative entries (K5's packing then gives it a unit guu diagonal),
    else the mask alone must zero its gains (K6a, K6b)."""
    st = stacks(np.random.default_rng(seed), B, T - 1, N, M)
    um = np.ones((T - 1, M), bool)
    um[:, -1] = False
    if zero_masked:
        st[1][..., -1] = 0.0
        st[3][..., -1] = 0.0
        st[5][..., -1, :] = 0.0
        st[5][..., :, -1] = 0.0
        st[6][..., -1, :] = 0.0
    return st, um


def _both(entry_port, entry_jax, st, um, reg, **jkw):
    out = entry_port(*(torch.as_tensor(a) for a in st), torch.as_tensor(um),
                     torch.as_tensor(reg))
    ref = entry_jax(*(jnp.asarray(a) for a in st), jnp.asarray(um),
                    jnp.asarray(reg), interpret=True, **jkw)
    for a, b in zip(out, ref):
        close(a.numpy(), np.asarray(b))
    return out


def test_wide_dims_take_k2s_template():
    """(12, 4) is a wide pair: K5, K6a and K6b resolve to the instantiations
    of K2's template, counted apart from K1's; dims past the rule's range
    (one lane and one step tile do not fit a block) raise."""
    for name in ("riccati_packed", "riccati_masked", "riccati_masked_packed"):
        for dtype, dn in ((torch.float32, "f32"), (torch.float64, "f64")):
            assert pk.riccati_plan(N, M, dtype).wide
            assert pk.family_symbol(name, N, M, dtype) == f"{name}_{dn}_n12_m4"
    assert pk.family_counter(pb.RICCATI_MASKED_LAUNCHES, pb.RICCATI_MASKED_WIDE_LAUNCHES,
                             pk.riccati_plan(N, M, torch.float32)) is pb.RICCATI_MASKED_WIDE_LAUNCHES
    assert pk.family_symbol("riccati_masked", 30, 3, torch.float32) == \
        "riccati_masked_f32_n30_m3"   # past n + m = 32: the tall template
    assert pk.family_symbol("riccati_masked", 60, 5, torch.float32) == \
        "riccati_masked_f32_n60_m5"   # past n + m = 64: the fit rule holds it
    with pytest.raises(NotImplementedError, match="riccati_plan.*the fit rule"):
        pk.family_symbol("riccati_masked", 200, 1, torch.float32)


def test_v3_entry_matches_jax_at_wide_dims():
    B = 130   # not a multiple of the JAX lane block
    st, um = _case(B, seed=1, zero_masked=True)
    reg = np.where(np.arange(B) % 4 == 0, 0.3, 0.0)
    _both(pk.backward_pass_batched_pallas_v3, jpk.backward_pass_batched_pallas_v3,
          st, um, reg, block_b=128, chunk=8)


def test_v1_entry_matches_jax_at_wide_dims():
    B = 10
    st, um = _case(B, seed=2, zero_masked=False)
    reg = np.linspace(0.0, 0.5, B)
    out = _both(pb.backward_pass_batched_pallas, jpb.backward_pass_batched_pallas,
                st, um, reg, block_b=8)
    assert (out[0].numpy()[:, :, -1, :] == 0.0).all()


def test_v2_entry_matches_jax_at_wide_dims():
    B = 130
    st, um = _case(B, seed=3, zero_masked=False)
    reg = np.where(np.arange(B) % 3 == 0, 0.2, 0.0)
    out = _both(pb.backward_pass_batched_pallas_v2, jpb.backward_pass_batched_pallas_v2,
                st, um, reg, block_b=128)
    assert (out[0].numpy()[:, :, -1, :] == 0.0).all()


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_batched_dispatch_matches_jax_at_wide_dims(variant):
    """The dispatch's batched rule at (12, 4) (the quadrotor's vmap route
    with ``backward_impl=make_backward_dispatch(...)``) equals JAX's
    vmapped dispatch in interpret mode."""
    B = 4
    st, um = _case(B, seed=4, zero_masked=False)
    reg = np.array([0.0, 0.1, 0.0, 1.0])
    dispatch = pb.make_backward_dispatch(variant=variant)
    jdispatch = jpb.make_backward_dispatch(interpret=True, block_b=128, variant=variant)
    args = tuple(torch.as_tensor(a) for a in st) + (torch.as_tensor(um), torch.as_tensor(reg))
    out = lane_call(dispatch, args, (True,) * 7 + (False, True), batched=True)
    ref = jax.vmap(lambda *a: jdispatch(*a[:7], jnp.asarray(um), a[7]))(
        *(jnp.asarray(a) for a in st), jnp.asarray(reg))
    for a, b in zip(out, ref):
        close(a.numpy(), np.asarray(b))
