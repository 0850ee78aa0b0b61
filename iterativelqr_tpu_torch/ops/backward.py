"""Backward Riccati recursion of the per-instance solver.

Counterpart of ``iterativelqr_tpu/ops/backward.py`` (its citations of the
reference live there):

* ``riccati_step`` / ``backward_pass_scan`` — the Gauss-Newton step and the
  reverse recursion as a Python loop over t (the JAX ``lax.scan``), on
  stacks with any leading lane axes, in the JAX operation order
  (``ops/linalg_small.py``).  Padded action dims carry an identity Quu block
  and zero gains.  With ``f2`` (``Options.ddp``) the step adds the full-DDP
  curvature terms with Tassa-style state regularization for the gains.
* ``backward_pass`` — the adaptive Quu regularization retry, one loop over
  lanes (``ops/batching.py::while_lanes``): each lane escalates its own
  ``reg`` until its factorizations are positive definite.
* the ``backward_pass="auto"`` dispatch (``_make_auto_dispatch``) — the
  JAX ``custom_vmap`` that takes the associative scan (``ops/assoc.py``)
  for unbatched and small-batch calls (``_assoc_wins``, the JAX package's
  rule) and the reverse scan for the rest.
"""

from __future__ import annotations

import functools

import torch

from . import linalg_small
from .assoc import backward_pass_associative
from .batching import custom_vmap, lane_call, while_lanes


def riccati_step(P, p, fx_t, fu_t, gx_t, gu_t, gxx_t, guu_t, gux_t, um, reg,
                 f2_t=None):
    """One backward step at t given the value function (P, p) at t+1; ``um``
    is the float action mask [nu], ``reg`` a scalar or per-lane [...].
    ``f2_t``: the dynamics second derivatives (fxx, fuu, fux) at t for full
    DDP (``Options.ddp``), contracted with the carried ``p`` (the value
    gradient at t+1), so this step cannot ride the associative or packed
    formulations.  Returns (P_new, p_new, ok, K, k, Qx, Qu)."""
    mm, mv = linalg_small.matmul, linalg_small.matvec
    fxT = fx_t.transpose(-1, -2)
    fuT = fu_t.transpose(-1, -2)
    Qx = gx_t + mv(fxT, p)
    Qu = gu_t + mv(fuT, p)
    fxTP = mm(fxT, P)
    fuTP = mm(fuT, P)
    Qxx = gxx_t + mm(fxTP, fx_t)
    Quu = guu_t + mm(fuTP, fu_t)
    Qux = gux_t + mm(fuTP, fx_t)
    if f2_t is not None:
        fxx_t, fuu_t, fux_t = f2_t
        pw = p[..., :, None, None]
        Qxx = Qxx + torch.sum(pw * fxx_t, dim=-3)
        Quu = Quu + torch.sum(pw * fuu_t, dim=-3)
        Qux = Qux + torch.sum(pw * fux_t, dim=-3)

    # padded action dims: identity diagonal so the factorization is well
    # posed and the corresponding gain rows vanish
    mask2 = um[:, None] * um[None, :]
    Quu_eff = Quu * mask2 + torch.diag(1.0 - um)
    reg2 = reg[..., None, None]
    if f2_t is not None:
        # state regularization through the value function for the gains
        # only (Tassa et al. 2012; the JAX step gives the measurements), a
        # 1e-3 diagonal share so that null(fu) can be cured too; the value
        # update keeps the unregularized terms.  At reg = 0 this is the
        # Gauss-Newton factorization.
        fuT_reg = fuT * reg2
        Quu_g = Quu_eff + mm(fuT_reg, fu_t) * mask2
        Qux_g = Qux + mm(fuT_reg, fx_t)
        Quu_reg = Quu_g + (1.0e-3 * reg2) * torch.diag(um)
    else:
        Qux_g = Qux
        Quu_reg = Quu_eff + reg2 * torch.diag(um)

    L = linalg_small.cholesky(Quu_reg)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = torch.all(torch.isfinite(diag) & (diag > 0.0), dim=-1)

    # K = -Quu \ Qux ; k = -Quu \ Qu
    sol = linalg_small.cho_solve(L, torch.cat([Qux_g, Qu[..., :, None]], dim=-1))
    K = -sol[..., :, :-1] * um[:, None]
    k = -sol[..., :, -1] * um

    # value update with the unregularized Quu
    KT = K.transpose(-1, -2)
    QuxT = Qux.transpose(-1, -2)
    QuuK = mm(Quu_eff, K)
    P_new = Qxx + mm(KT, QuuK) + mm(KT, Qux) + mm(QuxT, K)
    P_new = 0.5 * (P_new + P_new.transpose(-1, -2))
    p_new = Qx + mv(QuuK.transpose(-1, -2), k) + mv(KT, Qu) + mv(QuxT, k)
    return P_new, p_new, ok, K, k, Qx, Qu


def backward_pass_scan(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg, f2=None):
    """Reverse Riccati recursion on stacks with any leading lane axes.

    Returns (K [..., T-1, nu, nx], k [..., T-1, nu], Qx [..., T-1, nx],
    Qu [..., T-1, nu], p [..., T-1, nx] — the value gradient at t — and the
    all-timesteps PD flag [...]).  Terminal P = gxx_T, p = gx_T.  ``f2``:
    the (fxx [..., T-1, nx, nx, nx], fuu, fux) stacks of full DDP
    (``riccati_step``)."""
    dtype, device = gx.dtype, gx.device
    um = torch.as_tensor(u_mask, device=device).to(dtype)
    reg = torch.as_tensor(reg, dtype=dtype, device=device)
    P, p = gxx[..., -1, :, :], gx[..., -1, :]
    ok = torch.ones((), dtype=torch.bool, device=device)
    outs = []
    for t in range(fx.shape[-3] - 1, -1, -1):
        P, p, ok_t, K, k, Qx, Qu = riccati_step(
            P, p, fx[..., t, :, :], fu[..., t, :, :], gx[..., t, :],
            gu[..., t, :], gxx[..., t, :, :], guu[..., t, :, :],
            gux[..., t, :, :], um[t], reg,
            f2_t=None if f2 is None else tuple(a[..., t, :, :, :] for a in f2),
        )
        ok = ok & ok_t
        outs.append((K, k, Qx, Qu, p))
    outs.reverse()
    K, k, Qx, Qu, p = (torch.stack(a, dim=-3 if i == 0 else -2)
                       for i, a in enumerate(zip(*outs)))
    return K, k, Qx, Qu, p, ok


def _assoc_wins(B: int, T: int) -> bool:
    """The JAX package's (B, T) regime rule, measured on a TPU v5e: the
    associative scan for B <= max(1, T // 7)."""
    return B <= max(1, T // 7)


@functools.lru_cache(maxsize=None)
def _make_auto_dispatch():
    """The ``backward_pass="auto"`` dispatch: the associative scan unbatched
    and where ``_assoc_wins``, the reverse scan for batches that fill the
    card."""

    @custom_vmap
    def dispatch(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg):
        return backward_pass_associative(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg)

    @dispatch.def_vmap
    def _rule(axis_size, in_batched, fx, fu, gx, gu, gxx, guu, gux, u_mask, reg):
        T = (fx.shape[1] if in_batched[0] else fx.shape[0]) + 1
        um = u_mask[0] if in_batched[7] else u_mask
        bp = backward_pass_associative if _assoc_wins(axis_size, T) else backward_pass_scan
        return bp(fx, fu, gx, gu, gxx, guu, gux, um, reg)

    return dispatch


def backward_pass(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg_carry, options,
                  impl=None, batched=True, f2=None):
    """Backward pass with adaptive Quu regularization, per lane.

    Stacks carry the leading lane axis, ``u_mask`` [T-1, nu] is shared and
    ``reg_carry`` is [B].  The first attempt uses the carried ``reg``; a lane
    whose factorization fails escalates its ``reg`` geometrically and re-runs,
    and on success the carried value decays.  ``impl``: a recursion with the
    ``backward_pass_scan`` signature (per instance), called as the JAX
    program calls it (``ops/batching.py::lane_call``; ``batched`` False is
    the per-instance form of the solver).  ``f2``: the dynamics second
    derivatives of full DDP (``ops/derivatives.py::dynamics_hessians``),
    with the lane axes of the stacks: every attempt runs the reverse scan
    with them, whatever ``options.backward_pass`` says (the JAX solver
    passes the same recursion as its ``impl``).

    Returns (K, k, Qx, Qu, p, ok, reg_next_carry)."""
    if f2 is not None:
        bp = functools.partial(backward_pass_scan, f2=f2)
    elif options.backward_pass == "associative":
        bp = backward_pass_associative
    else:
        bp = backward_pass_scan
    if impl is None and f2 is None and options.backward_pass == "auto":
        impl = _make_auto_dispatch()
    stacks = (fx, fu, gx, gu, gxx, guu, gux)

    def run(reg):
        if impl is None:
            return bp(*stacks, u_mask, reg)
        return lane_call(impl, stacks + (u_mask, reg),
                         (True,) * 7 + (False, True), batched)

    def cond(s):
        i, _, _, ok, _ = s
        return (~ok) & (i <= options.max_regularization_steps)

    def body(s):
        i, reg, _, _, _ = s
        K, k, Qx, Qu, p, ok = run(reg)
        reg_next = torch.clamp(reg * options.regularization_scale,
                               options.regularization_min,
                               options.regularization_max)
        return (i + 1, reg_next, reg, ok, (K, k, Qx, Qu, p))

    if options.max_regularization_steps < 0:
        # no attempt: zero gains and ok false, the JAX loop's initial state
        Tm1, nx, nu = fx.shape[-3], fx.shape[-1], fu.shape[-1]
        lanes = fx.shape[:-3]
        K, k, Qx, Qu, p = (fx.new_zeros(lanes + s) for s in (
            (Tm1, nu, nx), (Tm1, nu), (Tm1, nx), (Tm1, nu), (Tm1, nx)))
        reg_used, ok = reg_carry, torch.zeros(reg_carry.shape, dtype=torch.bool,
                                              device=reg_carry.device)
    else:
        # the first attempt runs on every lane (its test cannot fail), so it
        # needs no host sync
        i0 = torch.zeros(reg_carry.shape, dtype=torch.int32, device=reg_carry.device)
        state = body((i0, reg_carry, reg_carry, None, None))
        _, _, reg_used, ok, (K, k, Qx, Qu, p) = while_lanes(
            cond, body, state, "regularization")

    # decay for the next iteration's first attempt
    reg_next_carry = torch.where(
        reg_used <= options.regularization_min,
        torch.zeros_like(reg_used),
        reg_used / options.regularization_scale,
    )
    return K, k, Qx, Qu, p, ok, reg_next_carry
