"""Unrolled small-matrix linear algebra for the Riccati recursion.

Counterpart of ``iterativelqr_tpu/ops/linalg_small.py``, in its operation
order: every function takes ``[..., m, m]`` / ``[..., m, k]`` tensors with
any leading (lane) axes and unrolls over the static trailing dims; above
``_UNROLL_MAX`` it takes the stock routine.  Products are
broadcast-multiply-reduce, as the JAX module writes them.
"""

from __future__ import annotations

import torch

_UNROLL_MAX = 12


def matmul(a, b):
    """Small-matrix product as broadcast-multiply-reduce."""
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    if k > _UNROLL_MAX or m * k * n > 1024:
        return a @ b
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def matvec(a, v):
    """[..., m, k] @ [..., k] -> [..., m] via broadcast-multiply-reduce."""
    if a.shape[-1] > _UNROLL_MAX * 2:
        return torch.einsum("...mk,...k->...m", a, v)
    return torch.sum(a * v[..., None, :], dim=-1)


def cholesky(A):
    """Lower-triangular Cholesky factor of PSD ``A`` [..., m, m]; NaN
    entries where a pivot is not positive (as ``jnp.linalg.cholesky``),
    which the callers' PD checks detect."""
    m = A.shape[-1]
    if m > _UNROLL_MAX:
        L, info = torch.linalg.cholesky_ex(A)
        return torch.where((info == 0)[..., None, None], L,
                           torch.full_like(L, float("nan")))
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(m)], dim=-1)
            for i in range(m)]
    return torch.stack(rows, dim=-2)


def cho_solve(L, B):
    """Solve A X = B given the Cholesky factor ``L`` of A; B is [..., m, k]."""
    m = L.shape[-1]
    if m > _UNROLL_MAX:
        return torch.cholesky_solve(B, L)
    # forward substitution: L Y = B
    Y = [None] * m
    for i in range(m):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k][..., None] * Y[k]
        Y[i] = s / L[..., i, i][..., None]
    # back substitution: L^T X = Y
    X = [None] * m
    for i in range(m - 1, -1, -1):
        s = Y[i]
        for k in range(i + 1, m):
            s = s - L[..., k, i][..., None] * X[k]
        X[i] = s / L[..., i, i][..., None]
    return torch.stack(X, dim=-2)


def solve(M, B):
    """General solve M X = B for small square M [..., m, m] by unrolled
    Gaussian elimination without pivoting (the well-conditioned systems of
    the associative Riccati composition); the stock solve above the unroll
    limit."""
    m = M.shape[-1]
    if m > _UNROLL_MAX:
        return torch.linalg.solve(M, B)
    A = [[M[..., i, j] for j in range(m)] for i in range(m)]
    R = [B[..., i, :] for i in range(m)]
    # forward elimination
    for p in range(m):
        inv = 1.0 / A[p][p]
        for i in range(p + 1, m):
            f = A[i][p] * inv
            for j in range(p + 1, m):
                A[i][j] = A[i][j] - f * A[p][j]
            R[i] = R[i] - f[..., None] * R[p]
    # back substitution
    X = [None] * m
    for i in range(m - 1, -1, -1):
        s = R[i]
        for j in range(i + 1, m):
            s = s - A[i][j][..., None] * X[j]
        X[i] = s / A[i][i][..., None]
    return torch.stack(X, dim=-2)
