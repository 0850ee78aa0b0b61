"""Port K5 (iterativelqr_tpu_torch/ops/packed_backward.py: pack_stacks,
pack_stacks_bt, backward_pass_packed, backward_pass_batched_pallas_v3)
against the JAX package's v3 Pallas kernel run in interpret mode, at (4, 1)
and (3, 2), with a batch that is not a multiple of the JAX lane block (128)
and a horizon that is not a multiple of its DMA chunk (8), in f64.

The port's packed buffer is [Tm1, F, B]: the JAX [Tp, F, S, 128] without the
tile padding of the batch and the pass-through steps of the horizon.  On the
CPU the wrapper takes its plain PyTorch version.  Tolerance 1e-10 relative
to the largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu.ops import packed_backward as jpk
from iterativelqr_tpu_torch.ops import packed_backward as pk

from test_torch_backward import close, stacks

torch.set_num_threads(1)

B, TM1 = 200, 10


def _case(n, m):
    st = stacks(np.random.default_rng(n + 10 * m), B, TM1, n, m)
    um = np.ones((TM1, m), bool)
    if m > 1:
        # an invalid action dim: exact-zero derivatives by construction,
        # and the packing's unit guu diagonal
        um[:, -1] = False
        st[1][..., -1] = 0.0
        st[3][..., -1] = 0.0
        st[5][..., -1, :] = 0.0
        st[5][..., :, -1] = 0.0
        st[6][..., -1, :] = 0.0
    reg = np.where(np.arange(B) % 4 == 0, 0.3, 0.0)
    return st, um, reg


@pytest.mark.parametrize("n,m", [(4, 1), (3, 2)])
def test_v3_entry_matches_jax(n, m):
    st, um, reg = _case(n, m)
    out = pk.backward_pass_batched_pallas_v3(
        *(torch.as_tensor(a) for a in st), torch.as_tensor(um), torch.as_tensor(reg))
    ref = jpk.backward_pass_batched_pallas_v3(
        *(jnp.asarray(a) for a in st), jnp.asarray(um), jnp.asarray(reg),
        block_b=128, chunk=8, interpret=True)
    for a, b in zip(out, ref):
        close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n,m", [(4, 1), (3, 2)])
def test_packed_pipeline_matches_jax(n, m):
    """pack_stacks_bt -> backward_pass_packed -> unflatten_bt / ok_vector,
    the batch-trailing route of the JAX fused pipeline."""
    st, um, reg = _case(n, m)
    last = [np.ascontiguousarray(np.moveaxis(a, 0, -1)) for a in st]
    packed, gxxT, gxT, meta = pk.pack_stacks_bt(
        *(torch.as_tensor(a) for a in last), torch.as_tensor(um))
    assert tuple(packed.shape) == (TM1, pk._offsets(n, m)[-1], B)
    assert set(meta) == {"B", "Bp", "Tm1", "Tp", "n", "m", "S_all"}
    outs = pk.backward_pass_packed(packed, gxxT, gxT, torch.as_tensor(reg), meta)

    # JAX: the batch-trailing stacks padded to whole 128-lane rows
    Bp = 256
    pad = lambda a: jnp.asarray(np.concatenate(
        [a, np.zeros(a.shape[:-1] + (Bp - B,))], axis=-1))
    jpacked, jgxxT, jgxT, jmeta = jpk.pack_stacks_bt(
        *(pad(a) for a in last), jnp.asarray(um), block_b=128, chunk=8)
    jouts = jpk.backward_pass_packed(
        jpacked, jgxxT, jgxT, jnp.asarray(np.concatenate([reg, np.zeros(Bp - B)])),
        jmeta, block_b=128, chunk=8, interpret=True)
    for a, b in zip(outs[:5], jouts[:5]):
        close(pk.unflatten_bt(a, meta).numpy(),
              np.asarray(jpk.unflatten_bt(b, jmeta))[..., :B])
    np.testing.assert_array_equal(pk.ok_vector(outs, meta).numpy(),
                                  np.asarray(jpk.ok_vector(jouts, jmeta))[:B])
    # the plain version on the packed buffer is what the CPU wrapper ran
    for a, b in zip(pk.backward_pass_packed_reference(packed, gxxT, gxT,
                                                      torch.as_tensor(reg), meta), outs):
        assert torch.equal(a, b)
