"""The backward recursion at any (n, m): the rule that picks K1's or K2's
template and its parameters (iterativelqr_tpu_torch/ops/packed_backward.py::
riccati_plan), the translation unit each (n, m, dtype) is built from, and
the plain recursion at dims no registered model has, against the JAX
package's Pallas kernels in interpret mode.

On the CPU the wrappers take their plain PyTorch versions; the CUDA
kernels at these dims are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py (phase 10).  f64 throughout;
tolerance 1e-10 relative to the largest value, as
tests/test_torch_packed_backward_wide.py: both sides are IEEE f64 and sum
the same products in other orders.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu.ops import packed_backward as jpk
from iterativelqr_tpu.ops import pallas_backward as jpb
from iterativelqr_tpu_torch import _build
from iterativelqr_tpu_torch.ops import packed_backward as pk
from iterativelqr_tpu_torch.ops import pallas_backward as pb
from test_torch_backward import close, stacks
from test_torch_packed_backward import _batch_last, _port_multiref

torch.set_num_threads(1)

TOL = 1e-10
GRID = ((3, 1), (4, 2), (5, 1), (5, 2), (6, 2), (7, 3), (13, 4), (14, 7), (24, 8))
F32, F64 = torch.float32, torch.float64


# (a) the rule ---------------------------------------------------------------


@pytest.mark.parametrize("n,m,template,depth,shared", [
    # the registered models' dims keep the template, ring and shared memory
    # they were built with: (f32, f64) each
    (4, 1, "K1", (8, 8), (47232, 94336)),     # acrobot, cartpole
    (3, 2, "K1", (8, 8), (40064, 80000)),     # car
    (2, 1, "K1", (8, 8), (16512, 32896)),     # particle, pendulum
    (12, 4, "K2", (3, 1), (219672, 226312)),  # quadrotor
])
def test_registered_dims_keep_their_kernels(n, m, template, depth, shared):
    for dtype, d, b in zip((F32, F64), depth, shared):
        plan = pk.riccati_plan(n, m, dtype)
        assert (plan.template, plan.lanes, plan.rows) == (template, 32, 1)
        assert plan.depth[0] == d and plan.shared[0] == b
        assert pk.kernel_symbol(n, m, dtype) == plan.symbol(plan.main)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_every_dims_in_range_fit_a_block(dtype):
    """Every (n, m) with n + m <= 32 gets a plan whose shared memory, masked
    or not, fits a block, with at least one ring tile and at most 1024
    threads; K2's lanes are the most that fit."""
    size = {F32: 4, F64: 8}[dtype]
    for n, m in itertools.product(range(1, 32), range(1, 32)):
        if n + m > pk.MAX_ROWS:
            continue
        plan = pk.riccati_plan(n, m, dtype)
        assert max(plan.shared) <= pk.SHARED_MAX == 232448, (n, m)
        assert min(plan.depth) >= 1 and plan.threads <= 1024, (n, m)
        if plan.wide:
            for lanes in (l for l in pk.K2_LANES if l > plan.lanes):
                assert min(pk._k2_ring(n, m, lanes, masked, size)[0]
                           for masked in (False, True)) < 1, (n, m, lanes)
        else:
            assert plan.rows == -(-n // pk.K1_TEAM) <= pk.K1_MAX_ROWS


def test_the_grid_takes_fewer_lanes_where_32_do_not_fit():
    """(13, 4) and (14, 7) fit 32 lanes in f32 and need 16 in f64; (24, 8)
    needs 16 lanes in f32 and 8 in f64; the template is the same in both
    dtypes."""
    lanes = {(n, m): tuple(pk.riccati_plan(n, m, d).lanes for d in (F32, F64))
             for n, m in GRID}
    assert lanes[13, 4] == lanes[14, 7] == (32, 16)
    assert lanes[24, 8] == (16, 8)
    for n, m in GRID:
        assert pk.riccati_plan(n, m, F32).template == pk.riccati_plan(n, m, F64).template


@pytest.mark.parametrize("n,m,dtype,match", [
    (30, 3, F32, "n \\+ m <= 32"),
    (1, 32, F64, "n \\+ m <= 32"),
    (0, 1, F32, "n >= 1"),
    (4, 1, torch.float16, "float32 or float64"),
    (12, 4, torch.float16, "float32 or float64"),
])
def test_refused_past_the_rule(n, m, dtype, match):
    with pytest.raises(NotImplementedError, match="riccati_plan.*" + match):
        pk.riccati_plan(n, m, dtype)


def test_a_template_asked_for_that_cannot_hold_the_dims_raises():
    with pytest.raises(NotImplementedError, match="K1's template holds"):
        pk.riccati_plan(12, 4, F32, template="K1")
    assert pk.riccati_plan(4, 1, F32, template="K2").lanes == 32


# (b) the translation unit ---------------------------------------------------


@pytest.mark.parametrize("n,m,dtype,header,lanes_line", [
    (4, 1, F32, "riccati_backward.cuh", None),
    (5, 2, F64, "riccati_backward.cuh", None),
    (12, 4, F32, "riccati_backward_wide.cuh", "#define RICCATI_WIDE_LANES 32"),
    (24, 8, F64, "riccati_backward_wide.cuh", "#define RICCATI_WIDE_LANES 8"),
])
def test_instantiation_source(n, m, dtype, header, lanes_line):
    plan = pk.riccati_plan(n, m, dtype)
    src = plan.source()
    tag, ctype = {F32: ("f32", "float"), F64: ("f64", "double")}[dtype]
    ring = "riccati_wide_ring" if plan.wide else "riccati_ring"
    assert f'#include "{header}"' in src
    assert f"RICCATI_FAMILY({plan.main}, {ring}, {n}, {m}, {ctype}, {tag})" in src
    assert (lanes_line in src) if lanes_line else "RICCATI_WIDE_LANES" not in src
    assert (_build.CSRC / header).exists()
    # the same text keys the same library; another dims or dtype another
    assert src == pk.riccati_plan(n, m, dtype).source()
    path = _build.generated_library_path(src)
    assert path == _build.generated_library_path(plan.source())
    other = pk.riccati_plan(n, m, F64 if dtype == F32 else F32).source()
    assert _build.generated_library_path(other) != path


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    """A generated library's name is keyed on csrc/'s headers as well as
    its own text: an edited template header builds a new library."""
    import shutil

    src = pk.riccati_plan(5, 2, F32).source()
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.generated_library_path(src)
    header = csrc / "riccati_backward.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.generated_library_path(src) != before


# (c) the plain recursion against JAX's kernel at new dims --------------------


def _jax_multiref(stacks_bl, reg, u_mask):
    """JAX's backward_pass_multiref (its own choice of kernel) on batch-last
    numpy stacks, B = S*128 -> batch-last."""
    B = stacks_bl[0].shape[-1]
    sl = lambda a: jnp.asarray(a.reshape(a.shape[:-1] + (B // 128, 128)))
    st = jpk.pad_stacks_sl(*(sl(a) for a in stacks_bl), jnp.asarray(u_mask))
    out = jpk.backward_pass_multiref(st[:7], st[7], st[8], sl(reg), st[9],
                                     block_b=128, interpret=True)
    return [np.asarray(o).reshape(o.shape[:-2] + (B,)) for o in out]


@pytest.mark.parametrize("n,m", [(5, 2), (13, 4)])
def test_plain_matches_jax_kernel_at_new_dims(n, m):
    """(5, 2) and (13, 4), f64, B=256, Tm1=24: indefinite Quu on 17 lanes
    at one step (ok = 0 there) and a per-lane regularizer."""
    B, Tm1 = 256, 24   # a multiple of the JAX kernels' chunk (8)
    rng = np.random.default_rng(20 + n)
    st = stacks(rng, B, Tm1, n, m)
    st[5][:17, 5] = -1.0e3
    reg = np.abs(rng.standard_normal(B))
    u_mask = np.ones((Tm1, m), bool)
    bl = [_batch_last(a) for a in st]
    ref = _jax_multiref(bl, reg, u_mask)
    out = _port_multiref(bl, reg, u_mask)
    for name, a, b in zip(["K", "k", "Qx", "Qu", "p", "ok"], ref, out):
        assert a.shape == b.shape, name
        close(b, a, TOL)
    assert (out[-1][:17] == 0).all() and (out[-1][17:] == 1).all()


# (d) K6a's plain version at the planar quadrotor's (6, 2) ---------------------


def test_masked_plain_matches_jax_kernel_at_6_2():
    """K6a's entry at (6, 2), f64, B=10, T=21, the last action masked on
    half the steps (its derivative entries nonzero: the mask alone zeroes
    its gains) and a per-lane regularizer, against JAX's v1 kernel in
    interpret mode."""
    B, T, n, m = 10, 21, 6, 2
    st = stacks(np.random.default_rng(62), B, T - 1, n, m)
    um = np.ones((T - 1, m), bool)
    um[::2, -1] = False
    reg = np.linspace(0.0, 0.5, B)
    out = pb.backward_pass_batched_pallas(*(torch.as_tensor(a) for a in st),
                                          torch.as_tensor(um), torch.as_tensor(reg))
    ref = jpb.backward_pass_batched_pallas(*(jnp.asarray(a) for a in st), jnp.asarray(um),
                                           jnp.asarray(reg), block_b=8, interpret=True)
    for a, b in zip(out, ref):
        close(a.numpy(), np.asarray(b), TOL)
    assert (out[0].numpy()[:, ::2, -1, :] == 0.0).all()
