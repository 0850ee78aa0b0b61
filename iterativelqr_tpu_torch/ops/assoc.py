"""Parallel-prefix (associative-scan) Riccati recursion.

Counterpart of ``iterativelqr_tpu/ops/assoc.py``, whose docstring derives
the value-function elements and their composition.  Each stage element is
``(A, b, C, eta, J)``: after completing the square in the action, the
conditional value function between t and t+1 is closed under composition,
so the whole backward sweep is one reverse prefix composition of T
elements, of depth about 2 log2(T), and the gains then come from one
Q-expansion over all timesteps at once.

Lane-polymorphic: stacks carry any leading lane axes (``fx [..., T-1, nx,
nx]`` and so on) and the time axis is the one before a stack's trailing
matrix or vector dims.  The small solves go through ``ops/linalg_small.py``
in the JAX operation order, and the prefix composition follows the
composition tree of ``jax.lax.associative_scan(..., reverse=True)``
(``_reverse_prefix``), so f64 results agree with the JAX package's to
rounding.  The JAX package computes this scan with XLA, not Pallas: it is
no TPU kernel, and its torch operations run on the card as they are.
"""

from __future__ import annotations

import torch

from . import linalg_small

# trailing (matrix or vector) rank of each element part: A, b, C, eta, J
_RANKS = (2, 1, 2, 1, 2)


def _t(a):
    return a.transpose(-1, -2)


def _combine(ei, ej):
    """Compose value-function elements: ``ei`` earlier in time than
    ``ej``.  M = I + C_i J_j is well conditioned (C, J PSD), so one
    unpivoted unrolled solve serves each side."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    nx = Ai.shape[-1]
    mm, mv = linalg_small.matmul, linalg_small.matvec
    I = torch.eye(nx, dtype=Ai.dtype, device=Ai.device)
    M = I + mm(Ci, Jj)
    rhs = torch.cat([Ai, (bi + mv(Ci, etaj))[..., None], Ci], dim=-1)
    sol = linalg_small.solve(M, rhs)
    D_Ai, D_bCe, D_Ci = sol[..., :nx], sol[..., nx], sol[..., nx + 1:]
    A = mm(Aj, D_Ai)
    b = mv(Aj, D_bCe) + bj
    C = mm(mm(Aj, D_Ci), _t(Aj)) + Cj
    C = 0.5 * (C + _t(C))
    # (I + J_j C_i)^{-1} v = solve(M', v): M' = I + J_j C_i for symmetric
    # J_j, C_i
    rhsT = torch.cat([(etaj - mv(Jj, bi))[..., None], mm(Jj, Ai)], dim=-1)
    solT = linalg_small.solve(_t(M), rhsT)
    eta = mv(_t(Ai), solT[..., 0]) + etai
    J = mm(_t(Ai), solT[..., 1:]) + Ji
    J = 0.5 * (J + _t(J))
    return A, b, C, eta, J


def _make_element(fx, fu, gx, gu, gxx, guu, gux, um, reg):
    """Every stage's value-function element at once (the time axis is a
    lane axis here); ``reg`` [...] per lane, ``um`` [T-1, nu].  Returns
    ((A, b, C, eta, J), ok [..., T-1])."""
    mm, mv = linalg_small.matmul, linalg_small.matvec
    nx = gux.shape[-1]
    mask2 = um[..., :, None] * um[..., None, :]
    Guu = (guu * mask2 + torch.diag_embed(1.0 - um)
           + reg[..., None, None, None] * torch.diag_embed(um))
    L = linalg_small.cholesky(Guu)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = torch.all(torch.isfinite(diag) & (diag > 0.0), dim=-1)
    sol = linalg_small.cho_solve(L, torch.cat([gux, gu[..., None], _t(fu)], dim=-1))
    Gi_Gux = sol[..., :nx]                       # Guu^{-1} Gux
    Gi_gu = sol[..., nx]
    Gi_fuT = sol[..., nx + 1:]                   # Guu^{-1} fu'
    A = fx - mm(fu, Gi_Gux)
    b = mv(-fu, Gi_gu)
    C = mm(fu, Gi_fuT)
    C = 0.5 * (C + _t(C))
    J = gxx - mm(_t(gux), Gi_Gux)
    J = 0.5 * (J + _t(J))
    eta = -(gx - mv(_t(gux), Gi_gu))
    return (A, b, C, eta, J), ok


def _gains(fx, fu, gx, gu, gxx, guu, gux, um, P1, p1, reg):
    """Feedback and feedforward gains from the value function at t+1, at
    every t at once (no sequential dependence)."""
    mm, mv = linalg_small.matmul, linalg_small.matvec
    fuT = _t(fu)
    Qx = gx + mv(_t(fx), p1)
    Qu = gu + mv(fuT, p1)
    fuTP = mm(fuT, P1)
    Quu = guu + mm(fuTP, fu)
    Qux = gux + mm(fuTP, fx)
    mask2 = um[..., :, None] * um[..., None, :]
    Quu_eff = Quu * mask2 + torch.diag_embed(1.0 - um)
    L = linalg_small.cholesky(Quu_eff + reg[..., None, None, None] * torch.diag_embed(um))
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = torch.all(torch.isfinite(diag) & (diag > 0.0), dim=-1)
    sol = linalg_small.cho_solve(L, torch.cat([Qux, Qu[..., None]], dim=-1))
    K = -sol[..., :-1] * um[..., :, None]
    k = -sol[..., -1] * um
    return K, k, Qx, Qu, ok


def identity_element(nx, dtype, device=None):
    """The combine operator's identity: composing it on either side leaves
    the other element unchanged (A=I, b=0, C=0, eta=0, J=0)."""
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return (torch.eye(nx, dtype=dtype, device=device), z(nx), z(nx, nx),
            z(nx), z(nx, nx))


def _slice(elems, sl):
    """Each part sliced by ``sl`` along its time axis."""
    return tuple(a[(Ellipsis, sl) + (slice(None),) * r]
                 for a, r in zip(elems, _RANKS))


def _cat(parts_a, parts_b):
    return tuple(torch.cat([a, b], dim=a.ndim - 1 - r)
                 for a, b, r in zip(parts_a, parts_b, _RANKS))


def _interleave(even, odd):
    """even[0], odd[0], even[1], odd[1], ... along each part's time axis
    (``even`` holds as many elements as ``odd`` or one more)."""
    out = []
    for e, o, r in zip(even, odd, _RANKS):
        d = e.ndim - 1 - r
        n_o = o.shape[d]
        head = e.narrow(d, 0, n_o)
        pair = torch.stack([head, o], dim=d + 1)
        pair = pair.reshape(pair.shape[:d] + (2 * n_o,) + pair.shape[d + 2:])
        if e.shape[d] > n_o:
            pair = torch.cat([pair, e.narrow(d, n_o, 1)], dim=d)
        out.append(pair)
    return tuple(out)


def _scan(fn, elems):
    """Inclusive prefix of ``fn`` along the time axis, by the odd/even
    recursion of ``jax.lax.associative_scan`` (the same composition tree)."""
    n = elems[0].shape[elems[0].ndim - 3]
    if n < 2:
        return elems
    reduced = fn(_slice(elems, slice(0, -1, 2)), _slice(elems, slice(1, None, 2)))
    odd = _scan(fn, reduced)
    if n % 2 == 0:
        even = fn(_slice(odd, slice(0, -1)), _slice(elems, slice(2, None, 2)))
    else:
        even = fn(odd, _slice(elems, slice(2, None, 2)))
    even = _cat(_slice(elems, slice(0, 1)), even)
    return _interleave(even, odd)


def _reverse_prefix(elems):
    """result[t] = e_t (x) e_{t+1} (x) ... (x) e_{T-1}: the JAX package's
    ``associative_scan(..., reverse=True)``, a forward scan over the flipped
    time axis whose operator's first argument is the temporally later
    accumulation, swapped into ``_combine``'s (earlier, later) order."""
    flip = lambda parts: tuple(a.flip(a.ndim - 1 - r) for a, r in zip(parts, _RANKS))
    return flip(_scan(lambda a, b: _combine(b, a), flip(elems)))


def backward_pass_associative(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg):
    """Associative-scan Riccati; same arguments and returns as
    ``ops/backward.py::backward_pass_scan``: (K [..., T-1, nu, nx], k,
    Qx, Qu, p [..., T-1, nx] — the value gradient at t — and the PD flag
    [...]).  ``reg`` is a scalar or per lane [...]."""
    dtype, device = gx.dtype, gx.device
    um = torch.as_tensor(u_mask, device=device).to(dtype)
    reg = torch.as_tensor(reg, dtype=dtype, device=device)
    reg = reg.expand(fx.shape[:-3])
    stage, ok_stage = _make_element(fx, fu, gx[..., :-1, :], gu, gxx[..., :-1, :, :],
                                    guu, gux, um, reg)
    zA = torch.zeros_like(gxx[..., -1:, :, :])
    term = (zA, torch.zeros_like(gx[..., -1:, :]), zA, -gx[..., -1:, :],
            gxx[..., -1:, :, :])
    _, _, _, eta_all, J_all = _reverse_prefix(_cat(stage, term))
    P = J_all           # value Hessian at each t
    p = -eta_all        # value gradient at each t
    K, k, Qx, Qu, ok_gain = _gains(fx, fu, gx[..., :-1, :], gu, gxx[..., :-1, :, :],
                                   guu, gux, um, P[..., 1:, :, :], p[..., 1:, :], reg)
    ok = (torch.all(ok_stage, dim=-1) & torch.all(ok_gain, dim=-1)
          & torch.all(torch.isfinite(p), dim=(-2, -1)))
    return K, k, Qx, Qu, p[..., :-1, :], ok
