"""Port K1 (iterativelqr_tpu_torch/ops/packed_backward.py) against the JAX
package's Pallas kernel ``backward_pass_multiref`` run in interpret mode.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is compared with that plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu.ops import packed_backward as jpk
from iterativelqr_tpu_torch.ops import packed_backward as pk

torch.set_num_threads(1)

RTOL = ATOL = 1e-10


def _stacks(rng, B, Tm1, n, m, dtype=np.float64):
    """Random well-conditioned batch-leading derivative stacks."""
    T = Tm1 + 1
    fx = 0.2 * rng.standard_normal((B, Tm1, n, n)) + np.eye(n)
    fu = rng.standard_normal((B, Tm1, n, m))
    gx = rng.standard_normal((B, T, n))
    gu = rng.standard_normal((B, Tm1, m))

    def spd(rows, d, scale):
        A = rng.standard_normal((B, rows, d, d))
        return scale * (A @ np.swapaxes(A, -1, -2)) / d + 2.0 * np.eye(d)

    gxx = spd(T, n, 0.5)
    guu = spd(Tm1, m, 1.0)
    gux = 0.2 * rng.standard_normal((B, Tm1, m, n))
    return [a.astype(dtype) for a in (fx, fu, gx, gu, gxx, guu, gux)]


def _batch_last(a):
    return np.ascontiguousarray(np.moveaxis(a, 0, -1))


def _jax_multiref(stacks_bl, reg, u_mask):
    """JAX kernel on batch-last numpy stacks (B = S*128) -> batch-last."""
    B = stacks_bl[0].shape[-1]
    S = B // 128
    sl = lambda a: jnp.asarray(a.reshape(a.shape[:-1] + (S, 128)))
    st = jpk.pad_stacks_sl(*(sl(a) for a in stacks_bl), jnp.asarray(u_mask))
    out = jpk.backward_pass_multiref(
        st[:7], st[7], st[8], sl(reg), st[9], block_b=128, interpret=True
    )
    return [np.asarray(o).reshape(o.shape[:-2] + (B,)) for o in out]


def _port_multiref(stacks_bl, reg, u_mask):
    t = [torch.as_tensor(a) for a in stacks_bl]
    kin = pk.prepare_stacks(*t, torch.as_tensor(u_mask))
    out = pk.backward_pass_multiref(kin[:7], kin[7], kin[8], torch.as_tensor(reg))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("case", ["all_ok", "forced_not_ok", "reg_and_masked_u"])
def test_plain_k1_matches_jax_kernel(case):
    rng = np.random.default_rng(11)
    B, Tm1, n = 256, 12, 4   # Tm1 not a multiple of the JAX chunk (8)
    m = 2 if case == "reg_and_masked_u" else 1
    stacks = _stacks(rng, B, Tm1, n, m)
    u_mask = np.ones((Tm1, m), bool)
    reg = np.zeros(B)
    if case == "forced_not_ok":
        # indefinite Quu on some lanes at one step: NaN pivots, ok = 0
        stacks[5][:17, 5] = -1.0e3
    if case == "reg_and_masked_u":
        reg = np.abs(rng.standard_normal(B))
        u_mask[3:7, 1] = False
        for k in (1, 3, 5, 6):   # padded action dims carry exact zeros
            idx = (slice(None), slice(3, 7)) + (
                (slice(None), 1) if k == 1 else (1,)
            )
            stacks[k][idx] = 0.0
        stacks[5][:, 3:7, 0, 1] = 0.0
    bl = [_batch_last(a) for a in stacks]
    ref = _jax_multiref(bl, reg, u_mask)
    out = _port_multiref(bl, reg, u_mask)
    for name, a, b in zip(["K", "k", "Qx", "Qu", "p", "ok"], ref, out):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=name)
    ok = out[-1]
    if case == "forced_not_ok":
        assert (ok[:17] == 0).all() and (ok[17:] == 1).all()
    else:
        assert (ok == 1).all()


def test_prepare_stacks_guu_fixup():
    rng = np.random.default_rng(2)
    stacks = [torch.as_tensor(_batch_last(a)) for a in _stacks(rng, 3, 5, 3, 2)]
    u_mask = np.ones((5, 2), bool)
    u_mask[1, 1] = False
    kin = pk.prepare_stacks(*stacks, torch.as_tensor(u_mask))
    guu = stacks[5]
    d = kin[5] - guu
    assert torch.all(d[1, 1, 1] == 1.0)
    d[1, 1, 1] = 0.0
    assert torch.count_nonzero(d) == 0
    assert torch.equal(kin[7], stacks[4][-1]) and torch.equal(kin[8], stacks[2][-1])


@pytest.mark.parametrize("n,m,dtype,ok", [
    (4, 1, torch.float32, True),
    (4, 1, torch.float64, True),
    (4, 1, torch.float16, False),
    (12, 4, torch.float32, False),
])
def test_unsupported_instantiation_raises(n, m, dtype, ok):
    """An (n, m, dtype) without a compiled kernel raises before any launch
    (the wrapper never falls back to the plain version on a CUDA tensor)."""
    if ok:
        assert pk.kernel_symbol(n, m, dtype).startswith("riccati_backward_")
    else:
        with pytest.raises(NotImplementedError):
            pk.kernel_symbol(n, m, dtype)
