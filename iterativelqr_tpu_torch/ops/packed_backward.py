"""Batched backward Riccati recursion (K1, K2, K5) and its plain reference.

Counterpart of ``iterativelqr_tpu/ops/packed_backward.py``: the entry
``backward_pass_multiref`` runs the recursion on the card through one of
three hand-written CUDA recursion templates, picked by the problem's dims
and dtype (``riccati_plan``): K1, ``csrc/riccati_backward.cuh`` (the TPU
kernel ``_kernel_mr``), or K2 (the TPU kernel ``_kernel_mr_stream``),
``csrc/riccati_backward_wide.cuh`` up to n + m = 32 and
``csrc/riccati_backward_tall.cuh`` past it.  ``backward_pass_packed`` runs
K5 (the TPU kernel ``_kernel``, v3), the same recursion reading one packed
per-step buffer built by ``pack_stacks``/``pack_stacks_bt``, on the same
template as K1 or K2 at those dims; ``backward_pass_batched_pallas_v3`` is
its batch-leading drop-in.  ``backward_pass_multiref_reference`` is the same math as a
PyTorch loop over t (the ``_riccati_step`` of the JAX module), and serves
every one of these kernels and the masked K6a/K6b (``ops/pallas_backward.py``).

The JAX package traces its Pallas kernels at whatever (n, m) a problem
brings; here each (n, m, dtype) gets a translation unit of its own, written
by ``RiccatiPlan.source`` (the template's header, its parameters, and the
family K1 or K2, K5, K6a, K6b and the ring entry) and built at first use
into a library keyed on its text (``_build.build_generated``).

Layout: batch-last and contiguous, ``[Tm1, *dims, B]`` — an exact reshape of
the JAX package's ``[Tm1, *dims, S, 128]`` SL arrays (lane b = s*128 + l).
The packed buffer is ``[Tm1, F, B]``, the JAX ``[Tp, F, S, 128]`` without
the TPU tile padding of the batch.  The TPU kernels' horizon padding to a
multiple of their DMA chunk (pass-through steps that leave P and p
unchanged) is not needed here; the only stack fixup kept is the unit
diagonal on ``guu``'s invalid action dims (``prepare_stacks``, counterpart
of ``pad_stacks_sl``, and ``pack_stacks``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from .. import _build
from ..utils.profiling import LaunchCounter

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_C_TYPES = {"f32": "float", "f64": "double"}
_SIZES = {"f32": 4, "f64": 8}


RICCATI_LAUNCHES = LaunchCounter("riccati_backward")
RICCATI_WIDE_LAUNCHES = LaunchCounter("riccati_backward_wide")
RICCATI_PACKED_LAUNCHES = LaunchCounter("riccati_packed")
RICCATI_PACKED_WIDE_LAUNCHES = LaunchCounter("riccati_packed_wide")
# the same on the tall template (n + m > 32)
RICCATI_TALL_LAUNCHES = LaunchCounter("riccati_backward_tall")
RICCATI_PACKED_TALL_LAUNCHES = LaunchCounter("riccati_packed_tall")

# what the three templates can hold (csrc/riccati_backward.cuh, K1's;
# csrc/riccati_backward_wide.cuh, K2's; csrc/riccati_backward_tall.cuh, the
# tall one)
SHARED_MAX = 232448        # bytes of shared memory a block may take on the H100
K2_MAX_ROWS = 32           # n + m: K2's template has a row of threads for each
REGISTERS = 255            # 32-bit registers a thread may hold
K1_TEAM = 4                # threads a lane in K1's template
K1_MAX_ROWS = 2            # rows of P a team thread may own
K1_DEPTH = 8               # step tiles in K1's ring
K1_THREADS = 32 * K1_TEAM + 64   # a block: 32 lanes' teams and two producer warps
K2_LANES = (32, 16, 8, 4)  # lanes a block in K2's template, the first that fits
K2_MAX_DEPTH = 3
TALL_LANES = (8, 4, 2, 1)  # lanes a block in the tall template, the first that fits
TALL_MAX_DEPTH = 2
TALL_BARRIERS = 16         # bytes of the tall template's mbarriers (kMaxDepth, padded)


def _slots(n, m):
    """Values a lane of one step's inputs (a tile's slots)."""
    return 2 * n * n + 2 * n * m + n + m + m * m


def _tile_values(n, m, lanes, masked, size):
    """Values of one step tile (``riccati::StepTile``): the slots of its
    lanes, then the step's mask padded to 16 bytes."""
    per16 = 16 // size
    um = -(-m // per16) * per16 if masked else 0
    return _slots(n, m) * lanes + um


def _k2_state_values(n, m):
    """Values a lane of K2's state in shared memory (``State``): P, its
    unsymmetrized successor, p, Quu, Qux, Qu, K, k, Quu K."""
    return 2 * n * n + n + m * m + 3 * m * n + 2 * m


def k1_values(n, m) -> int:
    """Values a thread of K1's template holds in registers through a step
    (32-bit, as the solve's f32; f64 takes the same template so that its
    tests hold the kernel f32 runs): P and p, the step's inputs but gxx
    (a thread reads only its rows of that), for each row it owns (ceil(n /
    4)) a row each of gxx, fx^T P, Qxx and the new P and a column of fx, the
    gathered new P, and the control side (fu^T P, Quu, Qux, the Cholesky
    factor, K, Quu K, k)."""
    rows = -(-n // K1_TEAM)
    return (n * n + n + (_slots(n, m) - n * n) + 5 * rows * n + n * n
            + 2 * m * m + 4 * m * n + m)


def _k1_ring(n, m, masked, size):
    """(tiles, bytes a block) of K1's ring: K1_DEPTH tiles and a full and
    an empty mbarrier a tile."""
    return K1_DEPTH, K1_DEPTH * _tile_values(n, m, 32, masked, size) * size + 16 * K1_DEPTH


def _k2_ring(n, m, lanes, masked, size):
    """(tiles, bytes a block) of K2's ring at ``lanes`` lanes a block: as
    many tiles as fit beside the state (at most K2_MAX_DEPTH), a full
    mbarrier each; (0, state and one tile) where none fits."""
    tile = _tile_values(n, m, lanes, masked, size) * size
    state = _k2_state_values(n, m) * lanes * size
    depth = min(K2_MAX_DEPTH, (SHARED_MAX - state) // (tile + 8))
    if depth < 1:
        return 0, state + tile + 8
    return depth, depth * tile + state + 8 * depth


def _tall_state_values(n, m):
    """Values a lane of the tall template's state in shared memory
    (``State``): P with p as its last column, Qxx (then the new P
    unsymmetrized), Qx, Quu, Qux, Qu, k, and a scratch region that holds
    fx^T [P p] and fu^T [P p], then the factor, K and Quu K."""
    return (n * (n + 1) + n * n + n + m * m + m * n + 2 * m
            + max((n + m) * (n + 1), m * m + 2 * m * n))


def _tall_threads(lanes):
    """Threads a block of the tall template: a Cholesky warp a lane, the
    producer warp after them, and at least 8 warps."""
    return 32 * max(8, lanes + 1)


def _tall_ring(n, m, lanes, masked, size):
    """(tiles, bytes a block) of the tall template's ring at ``lanes`` lanes
    a block: as many tiles (each padded to 16 bytes) as fit beside the
    state and the step's mask (at most TALL_MAX_DEPTH), after the
    mbarriers; (0, the bytes with one tile) where none fits."""
    tile = -(-_tile_values(n, m, lanes, masked, size) * size // 16) * 16
    state = (_tall_state_values(n, m) * lanes + m) * size
    depth = min(TALL_MAX_DEPTH, (SHARED_MAX - TALL_BARRIERS - state) // tile)
    return max(depth, 0), TALL_BARRIERS + max(depth, 1) * tile + state


def _whole_warps(rows, lanes):
    g = 32 // lanes
    return -(-rows // g) * g


@dataclasses.dataclass(frozen=True)
class RiccatiPlan:
    """The recursion template and its parameters at one (n, m, dtype):
    ``template`` "K1" (``csrc/riccati_backward.cuh``), "K2"
    (``csrc/riccati_backward_wide.cuh``) or "tall"
    (``csrc/riccati_backward_tall.cuh``, K2's recursion past n + m = 32);
    ``rows``, the rows of P a team thread of K1's template owns (1 in K2's:
    a row of threads a row; 0 in the tall one: each phase hands its
    elements to the block's threads in turn); ``lanes`` a block; ``depth``
    (tiles of the ring) and ``shared`` (bytes a block), each (unmasked: K1,
    K2, K5; masked: K6a, K6b); ``threads`` a block; ``clocks``, the tall
    template's phase clocks built in (for measuring only: ``phase_clocks``;
    no solve's plan has them)."""

    n: int
    m: int
    dtype: str
    template: str
    rows: int
    lanes: int
    depth: tuple
    shared: tuple
    threads: int
    clocks: bool = False

    @property
    def wide(self) -> bool:
        return self.template == "K2"

    @property
    def tall(self) -> bool:
        return self.template == "tall"

    @property
    def suffix(self) -> str:
        """What a kernel's name takes on this template: "" on K1's,
        "_wide" on K2's, "_tall" on the tall one."""
        return {"K1": "", "K2": "_wide", "tall": "_tall"}[self.template]

    @property
    def main(self) -> str:
        """The seven-array recursion's name: K1's, K2's or the tall one's."""
        return "riccati_backward" + self.suffix

    @property
    def ring(self) -> str:
        """The ring entry's name."""
        return {"K1": "riccati_ring", "K2": "riccati_wide_ring",
                "tall": "riccati_tall_ring"}[self.template]

    def symbol(self, name: str) -> str:
        """The C entry of kernel ``name`` (``main``, ``riccati_packed``,
        ``riccati_masked``, ``riccati_masked_packed``, ``ring``) in this
        plan's library."""
        return f"{name}_{self.dtype}_n{self.n}_m{self.m}"

    def source(self) -> str:
        """The translation unit of this (n, m, dtype): the template's
        header and its parameters, and the family (riccati_policies.cuh's
        RICCATI_FAMILY)."""
        threads = (f"{self.threads} threads" if self.tall
                   else f"{self.rows} row(s) of P a thread")
        lines = [f"// Riccati recursion family at n={self.n}, m={self.m}, {self.dtype}: "
                 f"{self.template}'s template, {self.lanes} lanes a block, {threads}",
                 "// (written by iterativelqr_tpu_torch/ops/packed_backward.py::RiccatiPlan)"]
        if self.wide:
            lines += [f"#define RICCATI_WIDE_LANES {self.lanes}",
                      '#include "riccati_backward_wide.cuh"']
        elif self.tall:
            lines += [f"#define RICCATI_TALL_LANES {self.lanes}",
                      *(["#define RICCATI_TALL_CLOCKS 1"] if self.clocks else []),
                      '#include "riccati_backward_tall.cuh"']
        else:
            lines += ['#include "riccati_backward.cuh"']
        lines.append(f"RICCATI_FAMILY({self.main}, {self.ring}, {self.n}, {self.m}, "
                     f"{_C_TYPES[self.dtype]}, {self.dtype})")
        return "\n".join(lines) + "\n"


def _refuse(n, m, dtype, why):
    raise NotImplementedError(
        f"riccati_plan: no CUDA recursion template holds n={n}, m={m}, "
        f"dtype={dtype}: {why}")


@functools.lru_cache(maxsize=None)
def riccati_plan(n: int, m: int, dtype, template: str = None) -> RiccatiPlan:
    """The template, and its parameters, that runs the recursion at
    (n, m, dtype) on the card; ``template`` ("K1", "K2" or "tall") asks for
    one (for comparing them), else the rule picks:

    * K1's template where a thread's values (``k1_values``) fit its 255
      registers, its rows of P stay within K1_MAX_ROWS (n <= 8) and its
      ring of K1_DEPTH tiles fits a block's shared memory in f64 (so both
      dtypes take the same template): (2, 1), (3, 2), (4, 1) as before, and
      (3, 1), (4, 2), (5, 1), (5, 2), (6, 1);
    * else, up to n + m = 32, K2's template at the most lanes a block (32,
      16, 8, 4) whose state and at least one step tile fit SHARED_MAX
      bytes, as many tiles as fit (at most 3): (12, 4) at 32 lanes (3 tiles
      in f32, 1 in f64), (6, 2), (7, 3), (13, 4) and (14, 7) in f32 at 32
      lanes, (13, 4) and (14, 7) in f64 and (24, 8) in f32 at 16, (24, 8)
      in f64 at 8;
    * past n + m = 32 (K2's block has a row of threads for each of P's and
      Quu's rows), the tall template at the most lanes a block (8, 4, 2, 1)
      whose state (``_tall_state_values``) and one step tile fit SHARED_MAX
      bytes, as many tiles as fit (at most 2; ``_tall_ring``): (36, 12) at
      4 lanes in f32 and 2 in f64, (48, 16) at 2 and 1, (62, 2) at 2 and 1,
      (70, 4) at 2 and 1 (one tile), (4, 70) at 2 and 1.

    Where K1's and K2's templates both hold the dims, the rule follows
    their times on the card (``PERF.md`` §6, ``chip_smoke.py`` phase 10c):
    at (5, 1) and (6, 1) K1's is 1.36-1.52 x faster; at (5, 2) and (6, 2)
    they are within 15% of each other either way.

    The range is the fit rule: one lane's state and one step tile in a
    block's shared memory, in that dtype.  So the limit differs by dtype
    and by the split of n + m: in f64 from n + m = 76 (m = 1) through 82
    (m = 12) to 99 (m = 62); in f32 from 107 (m = 1) to 141.  It is the
    card's counterpart of the JAX package's VMEM budget
    (``iterativelqr_tpu/ops/packed_backward.py::_VMEM_BUDGET``):
    ``backward_pass_multiref`` streams its outputs (``_kernel_mr_stream``)
    once the direct outputs' blocks pass the TPU's scoped VMEM, sizes its
    chunk down to one step (``_auto_chunk``) and traces any (n, m) whose
    chunk fits.  The card's limits are per block and do not depend on T or
    B: a lane's state lives in one block for the whole sweep, and the
    outputs go straight to device memory.

    Refused (``NotImplementedError`` naming this rule): a dtype other than
    f32 and f64, n < 1 or m < 1, dims whose one lane and one step tile do
    not fit a block in that dtype (spreading a lane over a cluster's
    shared memory is not done), and a template asked for that cannot hold
    the dims.
    """
    if dtype not in _DTYPES:
        _refuse(n, m, dtype, "the kernels take float32 or float64")
    tag = _DTYPES[dtype]
    size = _SIZES[tag]
    if n < 1 or m < 1:
        _refuse(n, m, dtype, "the rule takes n >= 1 and m >= 1")
    # K1's template can hold the dims (its rows, its ring in f64), and the
    # rule takes it where a thread's values fit its registers
    k1_holds = n <= K1_TEAM * K1_MAX_ROWS and _k1_ring(n, m, True, 8)[1] <= SHARED_MAX
    if template is None:
        if n + m > K2_MAX_ROWS:
            template = "tall"
        else:
            template = "K1" if k1_holds and k1_values(n, m) <= REGISTERS else "K2"
    if template == "K1":
        if not k1_holds:
            _refuse(n, m, dtype,
                    f"K1's template holds n <= {K1_TEAM * K1_MAX_ROWS} and a ring of "
                    f"{_k1_ring(n, m, True, 8)[1]} <= {SHARED_MAX} bytes in f64")
        rings = [_k1_ring(n, m, masked, size) for masked in (False, True)]
        return RiccatiPlan(n, m, tag, "K1", -(-n // K1_TEAM), 32,
                           tuple(r[0] for r in rings), tuple(r[1] for r in rings),
                           K1_THREADS)
    if template == "tall":
        for lanes in TALL_LANES:
            rings = [_tall_ring(n, m, lanes, masked, size) for masked in (False, True)]
            if min(r[0] for r in rings) >= 1:
                return RiccatiPlan(n, m, tag, "tall", 0, lanes, tuple(r[0] for r in rings),
                                   tuple(r[1] for r in rings), _tall_threads(lanes))
        _refuse(n, m, dtype,
                f"the fit rule: one lane's state and one step tile of the tall template "
                f"take {_tall_ring(n, m, 1, True, size)[1]} > {SHARED_MAX} bytes of a "
                f"block's shared memory in {tag}")
    if template != "K2":
        raise ValueError(f"template {template!r}: 'K1', 'K2' or 'tall'")
    if n + m > K2_MAX_ROWS:
        _refuse(n, m, dtype, f"K2's template holds n + m <= {K2_MAX_ROWS} (a row of "
                             f"threads a row of P and Quu)")
    for lanes in K2_LANES:
        rings = [_k2_ring(n, m, lanes, masked, size) for masked in (False, True)]
        if min(r[0] for r in rings) >= 1:
            threads = lanes * (_whole_warps(n, lanes) + _whole_warps(m, lanes))
            return RiccatiPlan(n, m, tag, "K2", 1, lanes, tuple(r[0] for r in rings),
                               tuple(r[1] for r in rings), threads)
    _refuse(n, m, dtype,
            f"K2's state and one step tile at {K2_LANES[-1]} lanes a block take "
            f"{_k2_ring(n, m, K2_LANES[-1], True, size)[1]} > {SHARED_MAX} bytes")


def prepare_stacks(fx, fu, gx, gu, gxx, guu, gux, u_mask):
    """Batch-last stacks -> kernel inputs.  ``gx``/``gxx`` include the
    terminal row; returns (fx, fu, gx[:-1], gu, gxx[:-1], guu', gux, gxxT,
    gxT) with a unit diagonal added to ``guu`` on invalid action dims
    (their derivatives are exact zeros by construction, so the factor stays
    defined)."""
    m = fu.shape[2]
    um = torch.as_tensor(u_mask, device=fx.device).to(fx.dtype)   # [Tm1, m]
    eye = torch.eye(m, dtype=fx.dtype, device=fx.device)
    guu = guu + (eye[None] * (1.0 - um)[:, None, :])[..., None]
    return (fx, fu, gx[:-1], gu, gxx[:-1], guu, gux, gxx[-1], gx[-1])


# ---------------------------------------------------------------------------
# Plain reference (PyTorch loop over t)
# ---------------------------------------------------------------------------


def _mm(a, b):
    """(i,k,B),(k,j,B) -> (i,j,B)"""
    return torch.sum(a[:, :, None] * b[None, :, :], dim=1)


def _mv(a, v):
    """(i,k,B),(k,B) -> (i,B)"""
    return torch.sum(a * v[None], dim=1)


def _t(a):
    return a.transpose(0, 1)


def _chol(A, m):
    """Lower Cholesky factor of A [m, m, B], as rows of [B] entries
    (L[i][j], j <= i).  Right-looking, a column a pass, so that a call
    issues O(m) tensor operations: each entry takes its updates in the
    left-looking order (k = 0, 1, ..., one product then one subtraction
    each), then its division or square root, so it rounds bitwise as the
    entry-by-entry form (and as the kernels order them)."""
    A = A.clone()
    L = [[None] * m for _ in range(m)]
    for j in range(m):
        d = torch.sqrt(A[j, j])
        L[j][j] = d
        if j + 1 == m:
            break
        col = A[j + 1:, j] / d
        for i, c in enumerate(col.unbind(0), start=j + 1):
            L[i][j] = c
        A[j + 1:, j + 1:] = A[j + 1:, j + 1:] - col[:, None] * col[None, :]
    return L


def _chol_solve(L, cols, m):
    """(L L^T)^-1 col for each of ``cols`` ([m, B] each), by forward then
    back substitution, all columns at once: each entry's operations in
    the order of one column's substitution (the forward one right-looking,
    a row's subtractions k = 0, 1, ... as the left-looking loop makes
    them: O(m) tensor operations where that loop made O(m^2))."""
    R = torch.stack(cols, dim=0).clone()
    y = [None] * m
    for i in range(m):
        y[i] = R[:, i] / L[i][i]
        if i + 1 < m:
            below = torch.stack([L[k][i] for k in range(i + 1, m)], dim=0)
            R[:, i + 1:] = R[:, i + 1:] - below[None] * y[i][:, None]
    x = [None] * m
    for i in range(m - 1, -1, -1):
        s = y[i]
        for kk in range(i + 1, m):
            s = s - L[kk][i] * x[kk]
        x[i] = s / L[i][i]
    X = torch.stack(x, dim=1)
    return [X[c] for c in range(len(cols))]


def _riccati_step(n, m, reg, P, p, ok, fx, fu, gx, gu, gxx, guu, gux,
                  um=None, v2=False):
    """One backward Riccati step on (.., B) operands; returns
    (K, kff, Qx, Qu, P_new, p_new, ok).

    ``um`` (float [m], the step's action mask shared by all lanes) applies
    the mask inside the step, as the TPU kernels K6a (``v2`` False) and K6b
    (``v2`` True, its own operation order for Quu_eff) do; None is the
    mask-free step of K1, K2 and K5."""
    fxT = _t(fx)
    fuT = _t(fu)
    Qx = gx + _mv(fxT, p)
    Qu = gu + _mv(fuT, p)
    fxTP = _mm(fxT, P)
    fuTP = _mm(fuT, P)
    Qxx = gxx + _mm(fxTP, fx)
    Quu = guu + _mm(fuTP, fu)
    Qux = gux + _mm(fuTP, fx)

    eye = torch.eye(m, dtype=Quu.dtype, device=Quu.device)[..., None]
    if um is None:
        Quu_eff, Quu_reg = Quu, Quu + eye * reg
    else:
        mask2 = (um[:, None] * um[None, :])[..., None]
        Quu_eff = Quu * mask2 + eye * (1.0 - um)[None, :, None]
        reg_um = eye * (reg[None, None, :] * um[None, :, None])
        Quu_reg = Quu_eff + reg_um
        if v2:
            Quu_eff = Quu_reg - reg_um
    Lf = _chol(Quu_reg, m)
    for a in range(m):
        d = Lf[a][a]
        ok = ok & torch.isfinite(d) & (d > 0.0)

    cols = [Qux[:, jj] for jj in range(n)] + [Qu]
    sols = _chol_solve(Lf, cols, m)
    K = -torch.stack(sols[:n], dim=1)
    kff = -sols[n]
    if um is not None:
        K = K * um[:, None, None]
        kff = kff * um[:, None]

    KT = _t(K)
    QuxT = _t(Qux)
    QuuK = _mm(Quu_eff, K)
    P_new = Qxx + _mm(KT, QuuK) + _mm(KT, Qux) + _mm(QuxT, K)
    P_new = 0.5 * (P_new + _t(P_new))
    p_new = Qx + _mv(_t(QuuK), kff) + _mv(KT, Qu) + _mv(QuxT, kff)
    return K, kff, Qx, Qu, P_new, p_new, ok


def backward_pass_multiref_reference(stacks, gxxT, gxT, reg, um=None,
                                     v2=False):
    """Plain version of the kernels: same inputs and outputs as
    ``backward_pass_multiref``.  ``um`` [Tm1, m] (float) and ``v2`` select
    the masked step of K6a/K6b (``_riccati_step``)."""
    fx, fu, gx, gu, gxx, guu, gux = stacks
    Tm1, n = fx.shape[0], fx.shape[1]
    m = fu.shape[2]
    B = fx.shape[-1]
    K_t = fx.new_empty((Tm1, m, n, B))
    k_t = fx.new_empty((Tm1, m, B))
    Qx_t = fx.new_empty((Tm1, n, B))
    Qu_t = fx.new_empty((Tm1, m, B))
    p_t = fx.new_empty((Tm1, n, B))
    P, p = gxxT, gxT
    ok = torch.ones(B, dtype=torch.bool, device=fx.device)
    for t in range(Tm1 - 1, -1, -1):
        K, kff, Qx, Qu, P, p, ok = _riccati_step(
            n, m, reg, P, p, ok,
            fx[t], fu[t], gx[t], gu[t], gxx[t], guu[t], gux[t],
            um=None if um is None else um[t], v2=v2,
        )
        K_t[t], k_t[t], Qx_t[t], Qu_t[t], p_t[t] = K, kff, Qx, Qu, p
    return K_t, k_t, Qx_t, Qu_t, p_t, ok.to(fx.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def kernel_symbol(n: int, m: int, dtype: torch.dtype) -> str:
    """C entry point of the recursion (K1 or K2 on K2's or the tall
    template, ``riccati_plan``) at (n, m, dtype); raises past the rule's
    range."""
    plan = riccati_plan(n, m, dtype)
    return plan.symbol(plan.main)


def family_symbol(name: str, n: int, m: int, dtype: torch.dtype) -> str:
    """C entry point of K5 (``riccati_packed``), K6a (``riccati_masked``) or
    K6b (``riccati_masked_packed``) at (n, m, dtype), on K1's, K2's or the
    tall template (``riccati_plan``); raises past the rule's range."""
    return riccati_plan(n, m, dtype).symbol(name)


def family_counter(narrow: LaunchCounter, wide: LaunchCounter,
                   plan: RiccatiPlan, tall: LaunchCounter = None) -> LaunchCounter:
    """The launch count of a family member: its instantiation of K1's
    template, of K2's or of the tall one."""
    if plan.tall:
        return tall
    return wide if plan.wide else narrow


@functools.lru_cache(maxsize=None)
def _library(plan: RiccatiPlan) -> ctypes.CDLL:
    return _build.load_generated(plan.source())


def library(n: int, m: int, dtype: torch.dtype) -> ctypes.CDLL:
    """The kernel library of (n, m, dtype), built at its first use (a few
    seconds of nvcc) and loaded once per process."""
    return _library(riccati_plan(n, m, dtype))


def build(*dims, dtypes=(torch.float32,), sources=()) -> list:
    """Build the libraries of every (n, m) in ``dims`` in each of
    ``dtypes`` now, their nvcc runs started together with those of the
    other translation units ``sources`` (a generated model's K3/K4), so
    that no solve's loop waits for nvcc.  Returns the libraries' paths,
    the Riccati ones first."""
    plans = [riccati_plan(n, m, d) for n, m in dims for d in dtypes]
    return _build.build_generated(*(p.source() for p in plans), *sources)


def _kernel_fn(plan: RiccatiPlan, name: str, n_pointers: int):
    symbol = plan.symbol(name)
    fn = getattr(_library(plan), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn, symbol


def ring_entry(symbol: str, *args, lib) -> tuple:
    """(tiles, bytes of dynamic shared memory a block) from a C entry of
    the library ``lib`` that reports a kernel's ring of step tiles
    (``csrc/async_ring.cuh``); ``args`` are its int arguments."""
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
    depth, nbytes = ctypes.c_int(), ctypes.c_int()
    if fn(*args, ctypes.byref(depth), ctypes.byref(nbytes)) != 0:
        raise RuntimeError(f"{symbol} failed")
    return depth.value, nbytes.value


def riccati_ring(n: int, m: int, dtype: torch.dtype, masked: bool,
                 plan: RiccatiPlan = None) -> tuple:
    """The ring of the recursion template at (n, m, dtype) (or of ``plan``),
    masked (K6a, K6b) or not (K1, K2, K5), as its library reports it:
    (tiles, bytes of shared memory a block).  Builds the kernels on first
    use."""
    plan = riccati_plan(n, m, dtype) if plan is None else plan
    return ring_entry(plan.symbol(plan.ring), int(masked), lib=_library(plan))


PHASES = ("wait", "A1", "A2", "B", "C", "Q", "D", "E")   # csrc/riccati_backward_tall.cuh's Phase


def phase_clocks(plan: RiccatiPlan, reset: bool = True) -> dict:
    """{phase: cycles} of the tall template's steps (``PHASES``: the copy
    wait, then each phase up to its barrier), summed over the blocks of the
    launches of ``plan``'s library since the last reset; ``plan`` has
    ``clocks`` (a build for measuring only)."""
    if not (plan.tall and plan.clocks):
        raise ValueError("phase_clocks: a tall plan built with clocks=True")
    fn = _library(plan).riccati_tall_clocks
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    out = (ctypes.c_ulonglong * len(PHASES))()
    if fn(ctypes.addressof(out), int(reset)) != 0:
        raise RuntimeError("riccati_tall_clocks failed")
    return dict(zip(PHASES, out))


def new_outputs(Tm1, n, m, B, dtype, device):
    """Empty batch-last (K, k, Qx, Qu, p, ok) for a kernel to write."""
    shapes = ((Tm1, m, n, B), (Tm1, m, B), (Tm1, n, B), (Tm1, m, B),
              (Tm1, n, B), (B,))
    return tuple(torch.empty(s, dtype=dtype, device=device) for s in shapes)


def launch(plan: RiccatiPlan, name, counter, args, outs, Tm1, B):
    """Launch kernel ``name`` of ``plan``'s library on the current stream
    with the data pointers of ``args`` then ``outs``; raise on a CUDA error,
    else count the launch on ``counter``.  Returns ``outs``."""
    device = outs[0].device
    fn, symbol = _kernel_fn(plan, name, len(args) + len(outs))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(a.data_ptr() for a in (*args, *outs)), Tm1, B, stream)
    if err != 0:
        raise RuntimeError(
            f"{symbol} launch failed: CUDA error {err} (Tm1={Tm1}, B={B})"
        )
    counter.launches += 1
    return outs


def _check(name, a, shape, dtype, device):
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, expected {device}")
    if a.dtype != dtype:
        raise ValueError(f"{name} has dtype {a.dtype}, expected {dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {tuple(shape)}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def backward_pass_multiref(stacks, gxxT, gxT, reg):
    """Batched backward Riccati recursion.

    ``stacks`` = (fx [Tm1,n,n,B], fu [Tm1,n,m,B], gx [Tm1,n,B], gu [Tm1,m,B],
    gxx [Tm1,n,n,B], guu [Tm1,m,m,B], gux [Tm1,m,n,B]) from
    ``prepare_stacks``; ``gxxT`` [n,n,B], ``gxT`` [n,B], ``reg`` [B].
    Returns (K [Tm1,m,n,B], k [Tm1,m,B], Qx [Tm1,n,B], Qu [Tm1,m,B],
    p [Tm1,n,B], ok [B]) with ok 1.0 where every Cholesky pivot was finite
    and positive, else 0.0.

    CPU tensors take the plain reference.  CUDA tensors launch K1 or K2
    (``riccati_plan``: K2's template, or the tall one past n + m = 32;
    built at the dims' first use) on the current stream, without
    synchronising; dims past the rule's range raise.
    """
    fx = stacks[0]
    device = fx.device
    if device.type == "cpu":
        return backward_pass_multiref_reference(stacks, gxxT, gxT, reg)
    if device.type != "cuda":
        raise ValueError(f"backward_pass_multiref: unsupported device {device}")
    Tm1, n = fx.shape[0], fx.shape[1]
    m = stacks[1].shape[2]
    B = fx.shape[-1]
    dtype = fx.dtype
    plan = riccati_plan(n, m, dtype)
    shapes = (
        (Tm1, n, n, B), (Tm1, n, m, B), (Tm1, n, B), (Tm1, m, B),
        (Tm1, n, n, B), (Tm1, m, m, B), (Tm1, m, n, B),
    )
    names = ("fx", "fu", "gx", "gu", "gxx", "guu", "gux")
    for name, a, shape in zip(names, stacks, shapes):
        _check(name, a, shape, dtype, device)
    _check("gxxT", gxxT, (n, n, B), dtype, device)
    _check("gxT", gxT, (n, B), dtype, device)
    _check("reg", reg, (B,), dtype, device)
    counter = family_counter(RICCATI_LAUNCHES, RICCATI_WIDE_LAUNCHES, plan, RICCATI_TALL_LAUNCHES)
    return launch(plan, plan.main, counter, (*stacks, gxxT, gxT, reg),
                  new_outputs(Tm1, n, m, B, dtype, device), Tm1, B)


# ---------------------------------------------------------------------------
# K5: the recursion on one packed per-step buffer
# ---------------------------------------------------------------------------


def _offsets(n, m):
    o_fx = 0
    o_fu = o_fx + n * n
    o_gx = o_fu + n * m
    o_gu = o_gx + n
    o_gxx = o_gu + m
    o_guu = o_gxx + n * n
    o_gux = o_guu + m * m
    F = o_gux + m * n
    return o_fx, o_fu, o_gx, o_gu, o_gxx, o_guu, o_gux, F


def pack_stacks_bt(fx, fu, gx, gu, gxx, guu, gux, u_mask):
    """Batch-last stacks (fx [Tm1,n,n,B], gx [T,n,B], ...) -> (packed
    [Tm1,F,B], gxxT [n,n,B], gxT [n,B], meta), with a unit diagonal added
    to ``guu`` on invalid action dims (their derivative rows and columns are
    exact zeros by construction), so the kernel is mask-free.  ``meta`` has
    the JAX keys: ``Bp`` = B and ``Tp`` = Tm1 (no padding), ``S_all`` None
    (the batch is one axis)."""
    Tm1, n, _, B = fx.shape
    m = fu.shape[2]
    kin = prepare_stacks(fx, fu, gx, gu, gxx, guu, gux, u_mask)
    meta = dict(B=B, Bp=B, Tm1=Tm1, Tp=Tm1, n=n, m=m, S_all=None)
    return pack_slots(kin[:7]), kin[7].contiguous(), kin[8].contiguous(), meta


def pack_slots(stacks):
    """Seven batch-last per-step stacks (fx, fu, gx, gu, gxx, guu, gux, each
    [Tm1, *dims, B]) -> one contiguous [Tm1, F, B] buffer, slots in that
    order (``_offsets``)."""
    Tm1, B = stacks[0].shape[0], stacks[0].shape[-1]
    # slot counts from the shapes, not -1: an empty horizon (Tm1 = 0) too
    return torch.cat([a.reshape(Tm1, math.prod(a.shape[1:-1]), B) for a in stacks], dim=1)


def pack_stacks(fx, fu, gx, gu, gxx, guu, gux, u_mask):
    """Batch-leading stacks (fx [B,Tm1,n,n], gx [B,T,n], ...) -> packed, as
    ``pack_stacks_bt``."""
    return pack_stacks_bt(*(a.movedim(0, -1) for a in
                            (fx, fu, gx, gu, gxx, guu, gux)), u_mask)


def unpack_views(packed, n, m):
    """The seven per-step stacks [Tm1, *dims, B] of a packed buffer, as
    views."""
    Tm1, B = packed.shape[0], packed.shape[-1]
    o = _offsets(n, m)
    dims = ((n, n), (n, m), (n,), (m,), (n, n), (m, m), (m, n))
    return tuple(packed[:, o[i]:o[i + 1]].reshape(Tm1, *d, B)
                 for i, d in enumerate(dims))


def backward_pass_packed_reference(packed, gxxT, gxT, reg, meta):
    """Plain version of K5: same inputs and outputs as
    ``backward_pass_packed``."""
    return backward_pass_multiref_reference(
        unpack_views(packed, meta["n"], meta["m"]), gxxT, gxT, reg)


def backward_pass_packed(packed, gxxT, gxT, reg, meta):
    """Run the recursion on a packed buffer (K5).

    ``packed`` [Tm1, F, B], ``gxxT`` [n,n,B], ``gxT`` [n,B] from
    ``pack_stacks``/``pack_stacks_bt``; ``reg`` [B].  Returns batch-last
    (K [Tm1,m,n,B], k [Tm1,m,B], Qx [Tm1,n,B], Qu [Tm1,m,B], p [Tm1,n,B],
    ok [B]) with ok 1.0 where every Cholesky pivot was finite and positive.
    Regularization rides the whole diagonal (invalid dims carry the packing's
    unit diagonal, and their Qux/Qu rows are zero, so their gains stay 0).

    CPU tensors take the plain reference; CUDA tensors launch K5 (K1's,
    K2's or the tall template, by the dims) on the current stream, without
    synchronising.  The TPU kernel's lane blocks
    need the batch padded to a multiple of its block; K5 masks its ragged
    lane edge, so no padding is made.
    """
    n, m = meta["n"], meta["m"]
    device = packed.device
    if device.type == "cpu":
        return backward_pass_packed_reference(packed, gxxT, gxT, reg, meta)
    if device.type != "cuda":
        raise ValueError(f"backward_pass_packed: unsupported device {device}")
    Tm1, B, dtype = packed.shape[0], packed.shape[-1], packed.dtype
    plan = riccati_plan(n, m, dtype)
    _check("packed", packed, (Tm1, _offsets(n, m)[-1], B), dtype, device)
    _check("gxxT", gxxT, (n, n, B), dtype, device)
    _check("gxT", gxT, (n, B), dtype, device)
    _check("reg", reg, (B,), dtype, device)
    counter = family_counter(RICCATI_PACKED_LAUNCHES, RICCATI_PACKED_WIDE_LAUNCHES, plan,
                             RICCATI_PACKED_TALL_LAUNCHES)
    return launch(plan, "riccati_packed", counter, (packed, gxxT, gxT, reg),
                  new_outputs(Tm1, n, m, B, dtype, device), Tm1, B)


def unflatten_bt(a, meta):
    """Kernel output -> batch-last [Tm1, *dims, B]: the outputs already are
    (the JAX function drops the tile padding of the batch)."""
    return a


def ok_vector(outs, meta):
    """[B]-bool PD-success vector from kernel outputs."""
    return outs[5] > 0.5


def unpack_outputs(outs, meta):
    """Batch-last kernel outputs -> batch-leading (K [B,Tm1,m,n], k, Qx, Qu,
    p, ok [B] bool)."""
    return tuple(a.movedim(-1, 0) for a in outs[:5]) + (ok_vector(outs, meta),)


def backward_pass_batched_pallas_v3(fx, fu, gx, gu, gxx, guu, gux, u_mask,
                                    reg):
    """Drop-in batched entry (the contract of ``backward_pass_scan`` under
    vmap): packs batch-leading stacks, runs K5, unpacks."""
    packed, gxxT, gxT, meta = pack_stacks(fx, fu, gx, gu, gxx, guu, gux,
                                          u_mask)
    outs = backward_pass_packed(packed, gxxT, gxT,
                                reg.to(packed.dtype).contiguous(), meta)
    return unpack_outputs(outs, meta)
