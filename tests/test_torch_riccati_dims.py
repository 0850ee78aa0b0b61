"""The backward recursion at any (n, m): the rule that picks K1's, K2's or
the tall template and its parameters (iterativelqr_tpu_torch/ops/
packed_backward.py::riccati_plan), the translation unit each (n, m, dtype)
is built from, and the plain recursion at dims no registered model has,
against the JAX package's Pallas kernels in interpret mode.

On the CPU the wrappers take their plain PyTorch versions; the CUDA
kernels at these dims are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py (phases 10 and 11).  f64 throughout;
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
# past n + m = 32: chip_smoke.py phase 11's grid (past 64 at (70, 4), (4, 70))
TALL_GRID = ((20, 13), (24, 12), (36, 12), (48, 16), (62, 2), (2, 62), (70, 4), (4, 70))
F32, F64 = torch.float32, torch.float64
# the fit rule's limits: the least n + m that one lane and one step tile of
# the tall template do not fit (m = 1), and the most n + m that they fit
LIMITS = {F32: (108, 141), F64: (77, 99)}


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
    """Every (n, m) whose one lane and one step tile of the tall template
    fit a block in that dtype (the fit rule) gets a plan whose shared
    memory, masked or not, fits a block, with at least one ring tile and at
    most 1024 threads; K2's lanes (n + m <= 32) and the tall template's
    (past 32) are the most that fit.  Every other (n, m) is refused naming
    the rule, and the range covers every n + m below its least refusal
    (LIMITS)."""
    size = {F32: 4, F64: 8}[dtype]
    first, last = LIMITS[dtype]
    for n, m in itertools.product(range(1, last + 2), range(1, last + 2)):
        if n + m > last + 1:
            continue
        fits = min(pk._tall_ring(n, m, 1, masked, size)[0] for masked in (False, True)) >= 1
        assert fits or n + m >= first, (n, m)
        assert not fits or n + m <= last, (n, m)
        if not fits:
            with pytest.raises(NotImplementedError, match="riccati_plan.*the fit rule"):
                pk.riccati_plan(n, m, dtype)
            continue
        plan = pk.riccati_plan(n, m, dtype)
        assert max(plan.shared) <= pk.SHARED_MAX == 232448, (n, m)
        assert min(plan.depth) >= 1 and plan.threads <= 1024, (n, m)
        assert plan.tall == (n + m > pk.K2_MAX_ROWS == 32), (n, m)
        if plan.wide:
            for lanes in (l for l in pk.K2_LANES if l > plan.lanes):
                assert min(pk._k2_ring(n, m, lanes, masked, size)[0]
                           for masked in (False, True)) < 1, (n, m, lanes)
        elif plan.tall:
            assert plan.threads == 32 * max(8, plan.lanes + 1)
            for lanes in (l for l in pk.TALL_LANES if l > plan.lanes):
                assert min(pk._tall_ring(n, m, lanes, masked, size)[0]
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
    # past the fit rule: one lane and one step tile do not fit a block in
    # this dtype ((76, 1) in f32 is held)
    (76, 1, F64, "the fit rule: .* 235992 > 232448 bytes .* in f64"),
    (200, 1, F32, "the fit rule: .* > 232448 bytes .* in f32"),
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
    with pytest.raises(NotImplementedError, match="K2's template holds n \\+ m <= 32"):
        pk.riccati_plan(30, 3, F32, template="K2")
    assert pk.riccati_plan(12, 4, F32, template="tall").lanes == 8


@pytest.mark.parametrize("n,m,dtype,lanes,threads,depth,shared", [
    # once refused (n + m > 32), now held
    (30, 3, F32, 8, 288, (2, 2), (225052, 225084)),
    (1, 32, F64, 8, 288, (1, 1), (213712, 213968)),
    # the team of three quadrotors, in f32 (the solve's) and f64
    (36, 12, F32, 4, 256, (2, 2), (197440, 197536)),
    (36, 12, F64, 2, 256, (2, 2), (197488, 197680)),
    # one lane a block in f64
    (62, 2, F64, 1, 256, (2, 2), (223904, 223936)),
    (2, 62, F64, 2, 256, (1, 1), (198272, 198768)),
    # past n + m = 64, once refused: held by the fit rule in both dtypes
    (70, 4, F32, 2, 256, (1, 1), (207616, 207632)),
    (70, 4, F64, 1, 256, (1, 1), (207632, 207664)),
    (4, 70, F32, 2, 256, (2, 2), (175912, 176488)),
    (4, 70, F64, 1, 256, (2, 2), (176192, 177312)),
    (60, 5, F32, 2, 256, (2, 2), (219236, 219300)),
    (1, 64, F64, 2, 256, (1, 1), (205440, 205952)),
    # refused in f64 (one lane does not fit), held in f32
    (76, 1, F32, 1, 256, (2, 2), (165140, 165172)),
])
def test_tall_dims_hold_a_plan(n, m, dtype, lanes, threads, depth, shared):
    """Past n + m = 32 the rule takes the tall template at the most lanes a
    block (8, 4, 2, 1) whose state and one step tile fit, as many tiles as
    fit (at most 2), 32 max(4, lanes + 1) threads (a Cholesky warp a lane,
    the producer warp, at least 8 warps); its kernels are named
    ``*_tall``."""
    plan = pk.riccati_plan(n, m, dtype)
    assert (plan.template, plan.lanes, plan.depth, plan.shared) == ("tall", lanes, depth, shared)
    assert plan.threads == threads == 32 * max(8, lanes + 1) and plan.rows == 0
    assert (plan.main, plan.ring) == ("riccati_backward_tall", "riccati_tall_ring")
    assert pk.kernel_symbol(n, m, dtype) == f"riccati_backward_tall_{plan.dtype}_n{n}_m{m}"
    assert pk.family_counter(pk.RICCATI_PACKED_LAUNCHES, pk.RICCATI_PACKED_WIDE_LAUNCHES, plan,
                             pk.RICCATI_PACKED_TALL_LAUNCHES) is pk.RICCATI_PACKED_TALL_LAUNCHES
    size = {F32: 4, F64: 8}[dtype]
    for masked in (False, True):
        tile = -(-pk._tile_values(n, m, lanes, masked, size) * size // 16) * 16
        state = (pk._tall_state_values(n, m) * lanes + m) * size
        assert plan.shared[masked] == pk.TALL_BARRIERS + depth[masked] * tile + state


# (b) the translation unit ---------------------------------------------------


@pytest.mark.parametrize("n,m,dtype,header,lanes_line", [
    (4, 1, F32, "riccati_backward.cuh", None),
    (5, 2, F64, "riccati_backward.cuh", None),
    (12, 4, F32, "riccati_backward_wide.cuh", "#define RICCATI_WIDE_LANES 32"),
    (24, 8, F64, "riccati_backward_wide.cuh", "#define RICCATI_WIDE_LANES 8"),
    (36, 12, F32, "riccati_backward_tall.cuh", "#define RICCATI_TALL_LANES 4"),
    (62, 2, F64, "riccati_backward_tall.cuh", "#define RICCATI_TALL_LANES 1"),
])
def test_instantiation_source(n, m, dtype, header, lanes_line):
    plan = pk.riccati_plan(n, m, dtype)
    src = plan.source()
    tag, ctype = {F32: ("f32", "float"), F64: ("f64", "double")}[dtype]
    ring = {"K1": "riccati_ring", "K2": "riccati_wide_ring", "tall": "riccati_tall_ring"}[
        plan.template]
    assert f'#include "{header}"' in src
    assert f"RICCATI_FAMILY({plan.main}, {ring}, {n}, {m}, {ctype}, {tag})" in src
    assert (lanes_line in src) if lanes_line else "_LANES" not in src
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


@pytest.mark.parametrize("n,m,Tm1", [(5, 2, 24), (13, 4, 24), (36, 12, 8)])
def test_plain_matches_jax_kernel_at_new_dims(n, m, Tm1):
    """(5, 2), (13, 4) and the team's (36, 12) (where JAX takes its
    streamed kernel, ``_kernel_mr_stream``), f64, B=256, Tm1=24 (8 at (36,
    12), a multiple of the JAX kernels' chunk): indefinite Quu on 17 lanes
    at one step (ok = 0 there) and a per-lane regularizer."""
    B = 256
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


# (e) K6a's and K6b's plain versions past n + m = 32 -------------------------


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_masked_plain_matches_jax_kernels_at_24_12(variant):
    """K6a's (v1) and K6b's (v2) entries at (24, 12), where the rule takes
    the tall template, f64, B=128 (v2's lane block), T=9, the last action
    masked on half the steps (its derivative entries nonzero) and a
    per-lane regularizer, against JAX's kernels in interpret mode, to
    1e-10."""
    B, T, n, m = 128, 9, 24, 12
    assert pk.riccati_plan(n, m, F64).tall
    st = stacks(np.random.default_rng(2412), B, T - 1, n, m)
    um = np.ones((T - 1, m), bool)
    um[::2, -1] = False
    reg = np.linspace(0.0, 0.5, B)
    port = {"v1": pb.backward_pass_batched_pallas, "v2": pb.backward_pass_batched_pallas_v2}
    jax_fn = {"v1": jpb.backward_pass_batched_pallas, "v2": jpb.backward_pass_batched_pallas_v2}
    out = port[variant](*(torch.as_tensor(a) for a in st), torch.as_tensor(um),
                        torch.as_tensor(reg))
    ref = jax_fn[variant](*(jnp.asarray(a) for a in st), jnp.asarray(um), jnp.asarray(reg),
                          block_b=128, interpret=True)
    for a, b in zip(out, ref):
        close(a.numpy(), np.asarray(b), TOL)
    assert (out[0].numpy()[:, ::2, -1, :] == 0.0).all()


# (f) the plain recursion past n + m = 64 ------------------------------------


def test_plain_matches_jax_step_math_at_70_4():
    """At (70, 4), past the old n + m = 64 and held now by the fit rule in
    both dtypes: the port's plain recursion (what the tall template is held
    to on the card) against the JAX package's step math
    (``iterativelqr_tpu/ops/packed_backward.py::_riccati_step``, the body
    of its kernels, eager, a Python loop over t: its interpret-mode kernel
    would take minutes to trace here), f64, B=16, Tm1=4, indefinite Quu on
    3 lanes at one step and a per-lane regularizer, to 1e-10."""
    B, Tm1, n, m = 16, 4, 70, 4
    assert pk.riccati_plan(n, m, F32).tall and pk.riccati_plan(n, m, F64).tall
    rng = np.random.default_rng(704)
    st = stacks(rng, B, Tm1, n, m)
    st[5][:3, 1] = -1.0e3
    reg = np.abs(rng.standard_normal(B))
    bl = [_batch_last(a) for a in st]
    out = _port_multiref(bl, reg, np.ones((Tm1, m), bool))
    fx, fu, gx, gu, gxx, guu, gux = (jnp.asarray(a) for a in bl)
    P, p, ok = gxx[-1], gx[-1], jnp.ones(B)
    ref = [[None] * Tm1 for _ in range(5)]
    for t in range(Tm1 - 1, -1, -1):
        K, kff, Qx, Qu, P, p, ok = jpk._riccati_step(
            n, m, jnp.asarray(reg), P, p, ok, fx[t], fu[t], gx[t], gu[t], gxx[t], guu[t], gux[t])
        for i, a in enumerate((K, kff, Qx, Qu, p)):
            ref[i][t] = np.asarray(a)
    for name, a, b in zip(["K", "k", "Qx", "Qu", "p"], ref, out):
        close(b, np.stack(a), TOL)
    np.testing.assert_array_equal(out[-1], np.asarray(ok))
    assert (out[-1][:3] == 0).all() and (out[-1][3:] == 1).all()
