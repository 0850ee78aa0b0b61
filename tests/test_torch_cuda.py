"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: here they skip when torch finds no card.  On a machine with
a card and without JAX (which tests/conftest.py imports), run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

This file imports torch and numpy only.
"""

import numpy as np
import pytest
import torch

from iterativelqr_tpu_torch.ops import packed_backward as pk


def _stacks(rng, B, Tm1, n, m):
    """Well-conditioned batch-last derivative stacks (numpy, f64)."""
    T = Tm1 + 1
    fx = 0.1 * rng.standard_normal((Tm1, n, n, B)) + np.eye(n)[None, :, :, None]
    fu = 0.1 * rng.standard_normal((Tm1, n, m, B))
    gx = rng.standard_normal((T, n, B))
    gu = rng.standard_normal((Tm1, m, B))
    A = rng.standard_normal((T, n, n, B))
    gxx = np.einsum("tikb,tjkb->tijb", A, A) / n + 0.1 * np.eye(n)[None, :, :, None]
    guu = 0.1 + np.abs(rng.standard_normal((Tm1, m, m, B)))
    gux = 0.05 * rng.standard_normal((Tm1, m, n, B))
    return [fx, fu, gx, gu, gxx, guu, gux]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_riccati_kernel_matches_plain(dtype, tol):
    """K1 at the main path's shapes (acrobot n=4, m=1, T=101, B=4096), with
    indefinite Quu on every 61st lane.  Tolerance relative to the largest
    value: the two sum in other orders (and the kernel contracts to FMA)
    through a 100-step recursion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, Tm1, n, m = 4096, 100, 4, 1
    st = _stacks(np.random.default_rng(5), B, Tm1, n, m)
    bad = np.zeros(B, bool)
    bad[::61] = True
    st[5][50, 0, 0, bad] = -1.0e3
    dev = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in st]
    kin = [a.contiguous() for a in pk.prepare_stacks(
        *dev, torch.ones((Tm1, m), dtype=torch.bool))]
    reg = torch.zeros(B, dtype=dtype, device="cuda")
    before = pk.RICCATI_LAUNCHES.launches
    out = pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
    torch.cuda.synchronize()
    assert pk.RICCATI_LAUNCHES.launches == before + 1
    ref = pk.backward_pass_multiref_reference(kin[:7], kin[7], kin[8], reg)
    for a, b in zip(out, ref):
        scale = float(b[~torch.isnan(b)].abs().max())
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * max(scale, 1.0),
                                   equal_nan=True)
    assert torch.equal(out[-1].cpu() == 0, torch.as_tensor(bad))


@pytest.mark.cuda
def test_riccati_kernel_rejects_what_it_was_not_built_for():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, Tm1 = 64, 5
    st = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
          for a in _stacks(np.random.default_rng(1), B, Tm1, 3, 2)]
    kin = [a.contiguous() for a in pk.prepare_stacks(
        *st, torch.ones((Tm1, 2), dtype=torch.bool))]
    reg = torch.zeros(B, device="cuda")
    with pytest.raises(NotImplementedError):
        pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
    st4 = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
           for a in _stacks(np.random.default_rng(1), B, Tm1, 4, 1)]
    kin4 = pk.prepare_stacks(*st4, torch.ones((Tm1, 1), dtype=torch.bool))
    with pytest.raises(ValueError, match="contiguous"):
        pk.backward_pass_multiref(
            (kin4[0].transpose(0, 1).contiguous().transpose(0, 1),) + tuple(kin4[1:7]),
            kin4[7].contiguous(), kin4[8].contiguous(), reg)
