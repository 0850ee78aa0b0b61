"""Port K6a/K6b (iterativelqr_tpu_torch/ops/pallas_backward.py) against the
JAX package's Pallas kernels ``backward_pass_batched_pallas`` (v1) and
``_v2`` run in interpret mode, on the cases of tests/test_pallas_backward.py,
in f64 from numpy seeds; and ``make_backward_dispatch``: unbatched equal to
the reverse scan, batched equal to JAX's vmapped dispatch.

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

from iterativelqr_tpu.ops import pallas_backward as jpb
from iterativelqr_tpu.ops.backward import backward_pass_scan as jax_scan
from iterativelqr_tpu_torch.ops import pallas_backward as pb
from iterativelqr_tpu_torch.ops.backward import backward_pass_scan
from iterativelqr_tpu_torch.ops.batching import lane_call

from test_torch_backward import close, stacks

torch.set_num_threads(1)


def _masked_case(B, T, n, m, seed):
    """Stacks with the last action dim masked (when m > 1) and its
    derivative entries left nonzero, as the padded-action case of
    tests/test_pallas_backward.py zeroes them: here the mask alone must
    zero the gains."""
    st = stacks(np.random.default_rng(seed), B, T - 1, n, m)
    um = np.ones((T - 1, m), bool)
    if m > 1:
        um[:, -1] = False
    return st, um


def _both(entry_port, entry_jax, st, um, reg, **jkw):
    out = entry_port(*(torch.as_tensor(a) for a in st), torch.as_tensor(um),
                     torch.as_tensor(reg))
    ref = entry_jax(*(jnp.asarray(a) for a in st), jnp.asarray(um),
                    jnp.asarray(reg), interpret=True, **jkw)
    for a, b in zip(out, ref):
        close(a.numpy(), np.asarray(b))
    return out


@pytest.mark.parametrize("n,m,B", [(4, 1, 8), (3, 2, 8), (5, 3, 6)])
def test_v1_matches_jax(n, m, B):
    st, um = _masked_case(B, 11, n, m, seed=n)
    reg = np.linspace(0.0, 0.5, B)
    out = _both(pb.backward_pass_batched_pallas, jpb.backward_pass_batched_pallas,
                st, um, reg, block_b=8)
    if m > 1:
        assert (out[0].numpy()[:, :, -1, :] == 0.0).all()


def test_v1_padded_batch_and_masked_actions():
    """B not a multiple of the JAX lane block; one action dim masked off,
    with its derivatives zeroed as tests/test_pallas_backward.py does."""
    T, n, m, B = 9, 4, 2, 5
    st, um = _masked_case(B, T, n, m, seed=1)
    st[1][..., -1] = 0.0
    st[3][..., -1] = 0.0
    st[5][..., -1, :] = 0.0
    st[5][..., :, -1] = 0.0
    st[6][..., -1, :] = 0.0
    out = _both(pb.backward_pass_batched_pallas, jpb.backward_pass_batched_pallas,
                st, um, np.zeros(B), block_b=4)
    assert (out[0].numpy()[:, :, -1, :] == 0.0).all()


@pytest.mark.parametrize("n,m,B", [(4, 1, 256), (3, 2, 300)])
def test_v2_matches_jax(n, m, B):
    st, um = _masked_case(B, 11, n, m, seed=3)
    reg = np.where(np.arange(B) % 3 == 0, 0.2, 0.0)
    _both(pb.backward_pass_batched_pallas_v2, jpb.backward_pass_batched_pallas_v2,
          st, um, reg, block_b=128)


def test_plain_versions_take_batch_last_stacks():
    """The plain versions of the kernels on batch-last stacks equal the
    batch-leading entries."""
    B, T, n, m = 6, 9, 3, 2
    st, um = _masked_case(B, T, n, m, seed=4)
    t = [torch.as_tensor(a) for a in st]
    last = [a.movedim(0, -1).contiguous() for a in t]
    umf = torch.as_tensor(um, dtype=torch.float64)
    reg = torch.full((B,), 0.1, dtype=torch.float64)
    lead = pb.backward_pass_batched_pallas(*t, torch.as_tensor(um), reg)
    for a, b in zip(pb.backward_pass_masked_reference(*last, umf, reg), lead):
        assert torch.equal(a.movedim(-1, 0), b.to(a.dtype))
    from iterativelqr_tpu_torch.ops import packed_backward as pk

    packed = pk.pack_slots((last[0], last[1], last[2][:-1], last[3], last[4][:-1],
                            last[5], last[6]))
    v2 = pb.backward_pass_masked_packed_reference(
        packed, last[4][-1], last[2][-1], umf, reg, dict(n=n, m=m))
    for a, b in zip(v2, pb.backward_pass_batched_pallas_v2(*t, torch.as_tensor(um), reg)):
        assert torch.equal(a.movedim(-1, 0), b.to(a.dtype))


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_dispatch_unbatched_and_batched(variant):
    """Unbatched: the reverse scan; batched: the kernel, equal to JAX's
    vmapped dispatch in interpret mode."""
    T, n, m, B = 7, 3, 1, 4
    st, um = _masked_case(B, T, n, m, seed=2)
    reg = np.array([0.0, 0.1, 0.0, 1.0])
    dispatch = pb.make_backward_dispatch(variant=variant)
    jdispatch = jpb.make_backward_dispatch(interpret=True, block_b=128, variant=variant)
    t = tuple(torch.as_tensor(a) for a in st)
    args = t + (torch.as_tensor(um), torch.as_tensor(reg))
    in_batched = (True,) * 7 + (False, True)
    out = lane_call(dispatch, args, in_batched, batched=True)
    ref = jax.vmap(lambda *a: jdispatch(*a[:7], jnp.asarray(um), a[7]))(
        *(jnp.asarray(a) for a in st), jnp.asarray(reg))
    for a, b in zip(out, ref):
        close(a.numpy(), np.asarray(b))
    one = lane_call(dispatch, tuple(a[:1] for a in args[:7]) + (args[7], args[8][:1]),
                    in_batched, batched=False)
    scan = backward_pass_scan(*(a[0] for a in t), args[7], args[8][0])
    for a, b in zip(one, scan):
        assert torch.equal(a[0], b)
    jone = jax_scan(*(jnp.asarray(a[0]) for a in st), jnp.asarray(um), reg[0])
    for a, b in zip(one, jone):
        close(a[0].numpy(), np.asarray(b))


def test_dispatch_refuses_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        pb.make_backward_dispatch(variant="v4")
