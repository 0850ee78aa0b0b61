"""Batched backward Riccati recursion (K1) and its plain reference.

Counterpart of ``iterativelqr_tpu/ops/packed_backward.py``: the entry
``backward_pass_multiref`` runs the recursion of the TPU kernel ``_kernel_mr``
on the card through the hand-written CUDA kernel
``csrc/riccati_backward.cu``, and ``backward_pass_multiref_reference`` is the
same math as a PyTorch loop over t (the ``_riccati_step`` of the JAX module).

Layout: batch-last and contiguous, ``[Tm1, *dims, B]`` — an exact reshape of
the JAX package's ``[Tm1, *dims, S, 128]`` SL arrays (lane b = s*128 + l).
The TPU kernel's horizon padding to a multiple of its DMA chunk is not
needed here; the only stack fixup kept is the unit diagonal on ``guu``'s
invalid action dims (``prepare_stacks``, counterpart of ``pad_stacks_sl``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

# (n, m) pairs with a compiled kernel, in each of float32 and float64; keep
# equal to the RICCATI_ENTRY list in csrc/riccati_backward.cu
_INSTANTIATIONS = ((4, 1),)
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


class LaunchCounter:
    """Counts kernel launches, so a run can show that its main path went
    through the kernel."""

    def __init__(self):
        self.launches = 0

    def reset(self):
        self.launches = 0


RICCATI_LAUNCHES = LaunchCounter()


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


def _riccati_step(n, m, reg, P, p, ok, fx, fu, gx, gu, gxx, guu, gux):
    """One backward Riccati step on (.., B) operands; returns
    (K, kff, Qx, Qu, P_new, p_new, ok)."""
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
    Lf = _chol(Quu + eye * reg, m)
    for a in range(m):
        d = Lf[a][a]
        ok = ok & torch.isfinite(d) & (d > 0.0)

    cols = [Qux[:, jj] for jj in range(n)] + [Qu]
    sols = _chol_solve(Lf, cols, m)
    K = -torch.stack(sols[:n], dim=1)
    kff = -sols[n]

    KT = _t(K)
    QuxT = _t(Qux)
    QuuK = _mm(Quu, K)
    P_new = Qxx + _mm(KT, QuuK) + _mm(KT, Qux) + _mm(QuxT, K)
    P_new = 0.5 * (P_new + _t(P_new))
    p_new = Qx + _mv(_t(QuuK), kff) + _mv(KT, Qu) + _mv(QuxT, kff)
    return K, kff, Qx, Qu, P_new, p_new, ok


def backward_pass_multiref_reference(stacks, gxxT, gxT, reg):
    """Plain version of the kernel: same inputs and outputs as
    ``backward_pass_multiref``."""
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
        )
        K_t[t], k_t[t], Qx_t[t], Qu_t[t], p_t[t] = K, kff, Qx, Qu, p
    return K_t, k_t, Qx_t, Qu_t, p_t, ok.to(fx.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def kernel_symbol(n: int, m: int, dtype: torch.dtype) -> str:
    """C entry point of the compiled (n, m, dtype) instantiation; raises
    when there is none."""
    if (n, m) not in _INSTANTIATIONS or dtype not in _DTYPES:
        raise NotImplementedError(
            f"riccati_backward has no CUDA instantiation for n={n}, m={m}, "
            f"dtype={dtype}; compiled: (n, m) in {_INSTANTIATIONS} x "
            f"{sorted(str(d) for d in _DTYPES)} (add one to "
            "csrc/riccati_backward.cu and _INSTANTIATIONS)"
        )
    return f"riccati_backward_{_DTYPES[dtype]}_n{n}_m{m}"


def _kernel_fn(symbol: str):
    fn = getattr(_build.load_library(), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 16 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


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

    CPU tensors take the plain reference.  CUDA tensors launch the kernel on
    the current stream, without synchronising; an (n, m, dtype) with no
    compiled instantiation raises.
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

    K_t = torch.empty((Tm1, m, n, B), dtype=dtype, device=device)
    k_t = torch.empty((Tm1, m, B), dtype=dtype, device=device)
    Qx_t = torch.empty((Tm1, n, B), dtype=dtype, device=device)
    Qu_t = torch.empty((Tm1, m, B), dtype=dtype, device=device)
    p_t = torch.empty((Tm1, n, B), dtype=dtype, device=device)
    ok = torch.empty((B,), dtype=dtype, device=device)
    fn = _kernel_fn(symbol)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *(a.data_ptr() for a in stacks),
            gxxT.data_ptr(), gxT.data_ptr(), reg.data_ptr(),
            K_t.data_ptr(), k_t.data_ptr(), Qx_t.data_ptr(), Qu_t.data_ptr(),
            p_t.data_ptr(), ok.data_ptr(), Tm1, B, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"riccati_backward launch failed: CUDA error {err} "
            f"({symbol}, Tm1={Tm1}, B={B})"
        )
    RICCATI_LAUNCHES.launches += 1
    return K_t, k_t, Qx_t, Qu_t, p_t, ok
