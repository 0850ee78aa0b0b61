"""Port K2's path (iterativelqr_tpu_torch/ops/packed_backward.py at the
quadrotor's n=12, m=4) against the JAX package's streamed-output Pallas
kernel ``_kernel_mr_stream``, run in interpret mode, and the rule that picks
K1 or K2.

The JAX entry takes the streamed kernel only where its direct outputs would
overflow the TPU's VMEM budget: at B=1024 with its default lane block and
Tm1=30 they do (the premise is asserted).  On the CPU the port's wrapper
takes its plain PyTorch version; the CUDA kernel itself is compared with
that plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu.ops import packed_backward as jpk
from iterativelqr_tpu_torch.ops import packed_backward as pk
from test_torch_packed_backward import _batch_last, _port_multiref, _stacks

torch.set_num_threads(1)

RTOL = ATOL = 1e-10
B, TM1, N, M = 1024, 30, 12, 4


def _jax_streamed(stacks_bl, reg, u_mask):
    """JAX's backward_pass_multiref at its default lane block on batch-last
    numpy stacks (B = S*128) -> batch-last."""
    S = B // 128
    sl = lambda a: jnp.asarray(a.reshape(a.shape[:-1] + (S, 128)))
    st = jpk.pad_stacks_sl(*(sl(a) for a in stacks_bl), jnp.asarray(u_mask))
    meta = st[9]
    chunk = jpk._auto_chunk(N, M)
    assert jpk._stream_outputs(N, M, meta["Tp"], chunk), \
        "test premise: these dims take the streamed-output kernel"
    out = jpk.backward_pass_multiref(st[:7], st[7], st[8], sl(reg), meta,
                                     interpret=True)
    return [np.asarray(o).reshape(o.shape[:-2] + (B,)) for o in out]


@pytest.mark.parametrize("case", ["all_ok", "forced_not_ok", "reg_and_masked_u"])
def test_plain_matches_jax_streamed_kernel(case):
    rng = np.random.default_rng(12)
    stacks = _stacks(rng, B, TM1, N, M)
    u_mask = np.ones((TM1, M), bool)
    reg = np.zeros(B)
    if case == "forced_not_ok":
        # indefinite Quu on some lanes at one step: NaN pivots, ok = 0
        stacks[5][:17, 5] = -1.0e3
    if case == "reg_and_masked_u":
        reg = np.abs(rng.standard_normal(B))
        u_mask[3:7, 2] = False
        # padded action dims carry exact zeros
        stacks[1][:, 3:7, :, 2] = 0.0
        stacks[3][:, 3:7, 2] = 0.0
        stacks[5][:, 3:7, 2, :] = 0.0
        stacks[5][:, 3:7, :, 2] = 0.0
        stacks[6][:, 3:7, 2] = 0.0
    bl = [_batch_last(a) for a in stacks]
    ref = _jax_streamed(bl, reg, u_mask)
    out = _port_multiref(bl, reg, u_mask)
    for name, a, b in zip(["K", "k", "Qx", "Qu", "p", "ok"], ref, out):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=name)
    ok = out[-1]
    if case == "forced_not_ok":
        assert (ok[:17] == 0).all() and (ok[17:] == 1).all()
        assert np.isnan(out[0][:6, ..., :17]).all()
    else:
        assert (ok == 1).all()


@pytest.mark.parametrize("n,m,wide", [
    (4, 1, False),    # acrobot, cartpole
    (3, 2, False),    # car
    (2, 1, False),    # pendulum
    (12, 4, True),    # quadrotor
    (5, 3, True),     # K1's values pass a thread's registers
    (5, 1, False),    # two rows of P a team thread
    (5, 2, False),
    (6, 2, True),     # the planar quadrotor: K1's values pass 255
    (7, 1, True),     # K1's ring of 8 tiles passes a block's shared memory in f64
    (24, 8, True),
])
def test_kernel_choice_is_the_register_budget(n, m, wide):
    """K1's template where a thread's values (``k1_values``: P, p, the
    step's inputs but gxx, its rows' temporaries, the gathered new P and
    the control side) fit 255 registers, its rows stay within two a thread
    and its ring fits a block in f64; K2's elsewhere; the same template in
    both dtypes."""
    k1 = (pk.k1_values(n, m) <= pk.REGISTERS and n <= pk.K1_TEAM * pk.K1_MAX_ROWS
          and pk._k1_ring(n, m, True, 8)[1] <= pk.SHARED_MAX)
    for dtype in (torch.float32, torch.float64):
        plan = pk.riccati_plan(n, m, dtype)
        assert plan.wide == wide == (not k1)
        assert plan.template == ("K2" if wide else "K1")

