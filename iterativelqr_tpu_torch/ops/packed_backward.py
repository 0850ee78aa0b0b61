"""Batched backward Riccati recursion (K1, K2, K5) and its plain reference.

Counterpart of ``iterativelqr_tpu/ops/packed_backward.py``: the entry
``backward_pass_multiref`` runs the recursion on the card through one of two
hand-written CUDA recursion templates, picked by the problem's dims
(``uses_wide_kernel``): K1, ``csrc/riccati_backward.cu`` (the TPU kernel
``_kernel_mr``), or K2, ``csrc/riccati_backward_wide.cu`` (the TPU kernel
``_kernel_mr_stream``).  ``backward_pass_packed`` runs K5 (the TPU kernel
``_kernel``, v3), the same recursion reading one packed per-step buffer
built by ``pack_stacks``/``pack_stacks_bt``: an instantiation of K1's
template at K1's dims and of K2's at the wide dims;
``backward_pass_batched_pallas_v3`` is its batch-leading drop-in.
``backward_pass_multiref_reference`` is the same math as a PyTorch loop over
t (the ``_riccati_step`` of the JAX module), and serves every one of these
kernels and the masked K6a/K6b (``ops/pallas_backward.py``).

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
import math

import torch

from .. import _build

# (n, m) pairs with a compiled kernel, in each of float32 and float64; keep
# equal to the RICCATI_FAMILY list in csrc/riccati_backward.cu (K1, K5, K6a,
# K6b on K1's template: acrobot and cartpole, car, particle and pendulum) and the RICCATI_WIDE_FAMILY list in
# csrc/riccati_backward_wide.cu (K2, K5, K6a, K6b on K2's template:
# quadrotor)
_INSTANTIATIONS = ((4, 1), (3, 2), (2, 1))
_WIDE_INSTANTIATIONS = ((12, 4),)
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


class LaunchCounter:
    """Counts kernel launches, so a run can show that its main path went
    through the kernel."""

    def __init__(self):
        self.launches = 0

    def reset(self):
        self.launches = 0


RICCATI_LAUNCHES = LaunchCounter()
RICCATI_WIDE_LAUNCHES = LaunchCounter()
RICCATI_PACKED_LAUNCHES = LaunchCounter()
RICCATI_PACKED_WIDE_LAUNCHES = LaunchCounter()

# K1 runs one thread per lane and keeps everything a step needs in that
# thread's registers, of which a thread has at most 255
_REGISTERS_PER_THREAD = 255


def k1_live_values(n: int, m: int) -> int:
    """Values K1 keeps live in one lane's thread: P and p, one step's
    inputs and the prefetched next step's, and the n x n temporaries fx^T P
    and Qxx."""
    step = 2 * n * n + 2 * n * m + n + m + m * m
    return n * n + n + 2 * step + 2 * n * n


def uses_wide_kernel(n: int, m: int) -> bool:
    """The kernel choice, a function of the dims alone: K2 where K1's
    per-lane values overflow a thread's registers (counted as 32-bit
    values, the solve's f32; f64 follows the same choice so that its tests
    hold the kernel f32 runs).  The JAX package's rule is a VMEM budget of
    the TPU (``_stream_outputs``); the register budget is its counterpart
    on the card.  Acrobot and cartpole (4, 1) need 144 values, car (3, 2)
    108 and particle and pendulum (2, 1) 46: K1; the quadrotor's (12, 4)
    needs 1,276: K2."""
    return k1_live_values(n, m) > _REGISTERS_PER_THREAD


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
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = A[i, j]
            for kk in range(j):
                s = s - L[i][kk] * L[j][kk]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    return L


def _chol_solve(L, cols, m):
    outs = []
    for col in cols:
        y = [None] * m
        for i in range(m):
            s = col[i]
            for kk in range(i):
                s = s - L[i][kk] * y[kk]
            y[i] = s / L[i][i]
        x = [None] * m
        for i in range(m - 1, -1, -1):
            s = y[i]
            for kk in range(i + 1, m):
                s = s - L[kk][i] * x[kk]
            x[i] = s / L[i][i]
        outs.append(torch.stack(x, dim=0))
    return outs


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
    """C entry point of the compiled (n, m, dtype) instantiation of the
    kernel ``uses_wide_kernel`` picks; raises when there is none."""
    if uses_wide_kernel(n, m):
        name, compiled, src = ("riccati_backward_wide", _WIDE_INSTANTIATIONS,
                               "riccati_backward_wide.cu and _WIDE_INSTANTIATIONS")
    else:
        name, compiled, src = ("riccati_backward", _INSTANTIATIONS,
                               "riccati_backward.cu and _INSTANTIATIONS")
    return _symbol(name, compiled, src, n, m, dtype)


def _symbol(name, compiled, src, n, m, dtype):
    if (n, m) not in compiled or dtype not in _DTYPES:
        raise NotImplementedError(
            f"{name} has no CUDA instantiation for n={n}, m={m}, "
            f"dtype={dtype}; compiled: (n, m) in {compiled} x "
            f"{sorted(str(d) for d in _DTYPES)} (add one to csrc/{src})"
        )
    return f"{name}_{_DTYPES[dtype]}_n{n}_m{m}"


def family_symbol(name: str, n: int, m: int, dtype: torch.dtype) -> str:
    """C entry point of K5 (``riccati_packed``), K6a (``riccati_masked``) or
    K6b (``riccati_masked_packed``) at (n, m, dtype): an instantiation of
    K1's recursion template, or of K2's where ``uses_wide_kernel``; raises
    when there is none."""
    if uses_wide_kernel(n, m):
        return _symbol(name, _WIDE_INSTANTIATIONS,
                       "riccati_backward_wide.cu (RICCATI_WIDE_FAMILY) and "
                       "_WIDE_INSTANTIATIONS", n, m, dtype)
    return _symbol(name, _INSTANTIATIONS,
                   "riccati_backward.cu (RICCATI_FAMILY) and _INSTANTIATIONS",
                   n, m, dtype)


def family_counter(narrow: LaunchCounter, wide: LaunchCounter, n: int,
                   m: int) -> LaunchCounter:
    """The launch count of a family member at (n, m): its instantiation of
    K1's template or of K2's (``uses_wide_kernel``)."""
    return wide if uses_wide_kernel(n, m) else narrow


def _kernel_fn(symbol: str, n_pointers: int):
    fn = getattr(_build.load_library(), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def ring_entry(symbol: str, *args, lib=None) -> tuple:
    """(tiles, bytes of dynamic shared memory a block) from a C entry of the
    kernel library (or ``lib``) that reports a kernel's ring of step tiles
    (``csrc/async_ring.cuh``); ``args`` are its int arguments."""
    fn = getattr(_build.load_library() if lib is None else lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
    depth, nbytes = ctypes.c_int(), ctypes.c_int()
    if fn(*args, ctypes.byref(depth), ctypes.byref(nbytes)) != 0:
        raise RuntimeError(f"{symbol} failed")
    return depth.value, nbytes.value


def riccati_ring(n: int, m: int, dtype: torch.dtype, masked: bool) -> tuple:
    """The ring of the recursion template at (n, m, dtype) (K1's, or K2's
    where ``uses_wide_kernel``), masked (K6a, K6b) or not (K1, K2, K5):
    (tiles, bytes of shared memory a block).  Builds the kernels on first
    use."""
    name = family_symbol("riccati_wide_ring" if uses_wide_kernel(n, m)
                         else "riccati_ring", n, m, dtype)
    return ring_entry(name, int(masked))


def new_outputs(Tm1, n, m, B, dtype, device):
    """Empty batch-last (K, k, Qx, Qu, p, ok) for a kernel to write."""
    shapes = ((Tm1, m, n, B), (Tm1, m, B), (Tm1, n, B), (Tm1, m, B),
              (Tm1, n, B), (B,))
    return tuple(torch.empty(s, dtype=dtype, device=device) for s in shapes)


def launch(symbol, counter, args, outs, Tm1, B):
    """Launch the C entry ``symbol`` on the current stream with the data
    pointers of ``args`` then ``outs``; raise on a CUDA error, else count
    the launch on ``counter``.  Returns ``outs``."""
    device = outs[0].device
    fn = _kernel_fn(symbol, len(args) + len(outs))
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
    (``uses_wide_kernel``) on the current stream, without synchronising; an
    (n, m, dtype) with no compiled instantiation raises.
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
    symbol = kernel_symbol(n, m, dtype)
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
    counter = RICCATI_WIDE_LAUNCHES if uses_wide_kernel(n, m) else RICCATI_LAUNCHES
    return launch(symbol, counter, (*stacks, gxxT, gxT, reg),
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

    CPU tensors take the plain reference; CUDA tensors launch K5 (K1's or
    K2's template, by the dims) on the current stream, without
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
    symbol = family_symbol("riccati_packed", n, m, dtype)
    _check("packed", packed, (Tm1, _offsets(n, m)[-1], B), dtype, device)
    _check("gxxT", gxxT, (n, n, B), dtype, device)
    _check("gxT", gxT, (n, B), dtype, device)
    _check("reg", reg, (B,), dtype, device)
    counter = family_counter(RICCATI_PACKED_LAUNCHES, RICCATI_PACKED_WIDE_LAUNCHES, n, m)
    return launch(symbol, counter, (packed, gxxT, gxT, reg),
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
