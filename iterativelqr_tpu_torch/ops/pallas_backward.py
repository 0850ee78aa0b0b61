"""Batched backward recursion with the action mask inside the step (K6a,
K6b), and the dispatch that runs it under the batched solve.

Counterpart of ``iterativelqr_tpu/ops/pallas_backward.py``, whose two TPU
kernels become two instantiations of a recursion template, K1's
(``csrc/riccati_backward.cuh``), K2's (``csrc/riccati_backward_wide.cuh``)
or the tall one (``csrc/riccati_backward_tall.cuh``) as
``packed_backward.riccati_plan`` picks for the dims, built at their first
use; the JAX kernels take any (n, m), and so do these, within the rule's
range (the fit rule: one lane's state and one step tile in a block):

* K6a (the TPU kernel ``_kernel``, v1): ``backward_pass_masked`` on seven
  batch-last stacks, the terminal P, p read from row Tm1 of ``gxx``/``gx``,
  the mask applied in the step: Quu_eff = Quu (um um^T) + diag(1 - um),
  Quu_reg = Quu_eff + diag(reg um), gains scaled by um, the value update on
  Quu_eff.  Entry ``backward_pass_batched_pallas``.
* K6b (the TPU kernel ``_kernel_v2``): ``backward_pass_masked_packed`` on
  K5's packed per-step buffer ``[Tm1, F, B]``, K6a's mask in its own order:
  Quu_eff = Quu_reg - diag(reg um), which does not round back to K6a's.
  Entry ``backward_pass_batched_pallas_v2``.

The entries keep the JAX contract: batch-leading stacks in (fx [B,T-1,n,n],
gx [B,T,n], ...), ``u_mask`` [T-1, m] shared, ``reg`` [B]; batch-leading
(K, k, Qx, Qu, p, ok bool [B]) out.  Like the JAX entries they transpose
(K6a) or pack (K6b) outside the kernel.  The mask is one [T-1, m] array
shared by all lanes (the JAX v1 wrapper broadcasts it over the batch for the
TPU's layout).  The TPU kernels' lane blocks need the batch padded to a
multiple of ``block_b`` (with unit-diagonal pad lanes); the kernels here mask
their ragged lane edge, so nothing is padded.  CPU tensors take the plain
versions ``*_reference`` (the same math as a PyTorch loop over t); CUDA
tensors launch the kernels or raise.

``make_backward_dispatch`` is the ``custom_vmap`` drop-in for
``backward_pass_scan``: its unbatched call is the reverse scan, its rule
sends the whole batch into K6a or K6b.  In the JAX package these kernels are
an internal experiment (``Options(backward_pass="pallas")`` raises) reached
only through that dispatch, as here.
"""

from __future__ import annotations

import torch

from . import packed_backward as pk
from .backward import backward_pass_scan
from .batching import custom_vmap

RICCATI_MASKED_LAUNCHES = pk.LaunchCounter("riccati_masked")
RICCATI_MASKED_PACKED_LAUNCHES = pk.LaunchCounter("riccati_masked_packed")
# the same at the wide dims (K2's template) and past n + m = 32 (the tall
# template)
RICCATI_MASKED_WIDE_LAUNCHES = pk.LaunchCounter("riccati_masked_wide")
RICCATI_MASKED_PACKED_WIDE_LAUNCHES = pk.LaunchCounter("riccati_masked_packed_wide")
RICCATI_MASKED_TALL_LAUNCHES = pk.LaunchCounter("riccati_masked_tall")
RICCATI_MASKED_PACKED_TALL_LAUNCHES = pk.LaunchCounter("riccati_masked_packed_tall")


def backward_pass_masked_reference(fx, fu, gx, gu, gxx, guu, gux, um, reg):
    """Plain version of K6a: same inputs and outputs as
    ``backward_pass_masked``."""
    return pk.backward_pass_multiref_reference(
        (fx, fu, gx[:-1], gu, gxx[:-1], guu, gux), gxx[-1], gx[-1], reg, um=um)


def backward_pass_masked(fx, fu, gx, gu, gxx, guu, gux, um, reg):
    """The masked recursion (K6a) on batch-last stacks: fx [Tm1,n,n,B],
    fu [Tm1,n,m,B], gx [T,n,B], gu [Tm1,m,B], gxx [T,n,n,B], guu [Tm1,m,m,B],
    gux [Tm1,m,n,B] (gx, gxx with the terminal row), um [Tm1,m] float,
    reg [B].  Returns batch-last (K [Tm1,m,n,B], k, Qx, Qu, p, ok [B] 1.0/0.0)."""
    device = fx.device
    if device.type == "cpu":
        return backward_pass_masked_reference(fx, fu, gx, gu, gxx, guu, gux, um, reg)
    if device.type != "cuda":
        raise ValueError(f"backward_pass_masked: unsupported device {device}")
    Tm1, n, _, B = fx.shape
    m = fu.shape[2]
    dtype = fx.dtype
    plan = pk.riccati_plan(n, m, dtype)
    shapes = ((Tm1, n, n, B), (Tm1, n, m, B), (Tm1 + 1, n, B), (Tm1, m, B),
              (Tm1 + 1, n, n, B), (Tm1, m, m, B), (Tm1, m, n, B), (Tm1, m), (B,))
    args = (fx, fu, gx, gu, gxx, guu, gux, um, reg)
    for name, a, shape in zip(("fx", "fu", "gx", "gu", "gxx", "guu", "gux", "um", "reg"),
                              args, shapes):
        pk._check(name, a, shape, dtype, device)
    counter = pk.family_counter(RICCATI_MASKED_LAUNCHES, RICCATI_MASKED_WIDE_LAUNCHES, plan,
                                RICCATI_MASKED_TALL_LAUNCHES)
    return pk.launch(plan, "riccati_masked", counter, args, pk.new_outputs(Tm1, n, m, B, dtype, device),
                     Tm1, B)


def backward_pass_masked_packed_reference(packed, gxxT, gxT, um, reg, meta):
    """Plain version of K6b: same inputs and outputs as
    ``backward_pass_masked_packed``."""
    return pk.backward_pass_multiref_reference(
        pk.unpack_views(packed, meta["n"], meta["m"]), gxxT, gxT, reg,
        um=um, v2=True)


def backward_pass_masked_packed(packed, gxxT, gxT, um, reg, meta):
    """The masked recursion in K6b's order (K6b) on a packed buffer
    [Tm1, F, B] (``pack_slots``; guu as derived, no unit diagonal), terminal
    gxxT [n,n,B], gxT [n,B], um [Tm1,m] float, reg [B]."""
    device = packed.device
    if device.type == "cpu":
        return backward_pass_masked_packed_reference(packed, gxxT, gxT, um, reg, meta)
    if device.type != "cuda":
        raise ValueError(f"backward_pass_masked_packed: unsupported device {device}")
    n, m = meta["n"], meta["m"]
    Tm1, B, dtype = packed.shape[0], packed.shape[-1], packed.dtype
    plan = pk.riccati_plan(n, m, dtype)
    args = (packed, gxxT, gxT, um, reg)
    shapes = ((Tm1, pk._offsets(n, m)[-1], B), (n, n, B), (n, B), (Tm1, m), (B,))
    for name, a, shape in zip(("packed", "gxxT", "gxT", "um", "reg"), args, shapes):
        pk._check(name, a, shape, dtype, device)
    counter = pk.family_counter(RICCATI_MASKED_PACKED_LAUNCHES,
                                RICCATI_MASKED_PACKED_WIDE_LAUNCHES, plan,
                                RICCATI_MASKED_PACKED_TALL_LAUNCHES)
    return pk.launch(plan, "riccati_masked_packed", counter, args, pk.new_outputs(Tm1, n, m, B, dtype, device),
                     Tm1, B)


def _last(a):
    """Batch-leading -> contiguous batch-last."""
    return a.movedim(0, -1).contiguous()


def _mask(u_mask, like):
    return torch.as_tensor(u_mask, device=like.device).to(like.dtype).contiguous()


def backward_pass_batched_pallas(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg):
    """Whole-batch masked backward pass through K6a.

    Batch-leading in: fx [B,T-1,n,n], fu [B,T-1,n,m], gx [B,T,n],
    gu [B,T-1,m], gxx [B,T,n,n], guu [B,T-1,m,m], gux [B,T-1,m,n],
    u_mask [T-1,m] bool (shared), reg [B].  Returns (K [B,T-1,m,n],
    k [B,T-1,m], Qx [B,T-1,n], Qu [B,T-1,m], p [B,T-1,n], ok [B] bool)."""
    outs = backward_pass_masked(
        *(_last(a) for a in (fx, fu, gx, gu, gxx, guu, gux)),
        _mask(u_mask, fx), reg.to(fx.dtype).contiguous())
    return pk.unpack_outputs(outs, None)


def backward_pass_batched_pallas_v2(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg):
    """K6b entry; same contract as ``backward_pass_batched_pallas``.  The
    stacks are packed into one [T-1, F, B] buffer outside the kernel."""
    m = fu.shape[-1]
    n = fx.shape[-1]
    packed = pk.pack_slots(tuple(a.movedim(0, -1) for a in (
        fx, fu, gx[:, :-1], gu, gxx[:, :-1], guu, gux)))
    meta = dict(n=n, m=m)
    outs = backward_pass_masked_packed(
        packed, _last(gxx[:, -1]), _last(gx[:, -1]), _mask(u_mask, fx),
        reg.to(fx.dtype).contiguous(), meta)
    return pk.unpack_outputs(outs, meta)


def make_backward_dispatch(unroll: int = 1, block_b=None, variant: str = "v1"):
    """A ``backward_pass_scan`` drop-in whose batched rule runs K6a
    (``variant="v1"``) or K6b (``"v2"``): pass it as ``backward_impl`` of
    ``core/solve.py::make_solve_fn``.  Unbatched calls (the per-instance
    form of the solver) take the reverse scan.  ``unroll`` and ``block_b``
    are the JAX function's scan unroll and TPU lane block, accepted for its
    signature and unused (the JAX ``interpret`` flag is dropped: the CPU
    runs the plain versions).  On the card the kernels of the spec's
    (n, m) are built when a solve with this dispatch starts."""
    kernels = {"v1": backward_pass_batched_pallas,
               "v2": backward_pass_batched_pallas_v2}
    if variant not in kernels:
        raise ValueError(f"unknown variant {variant!r}; 'v1' (K6a) or 'v2' (K6b)")
    kern = kernels[variant]

    dispatch = custom_vmap(backward_pass_scan)

    @dispatch.def_vmap
    def _rule(axis_size, in_batched, fx, fu, gx, gu, gxx, guu, gux, u_mask, reg):
        if not all(in_batched[:7]):
            raise NotImplementedError(
                "the masked backward dispatch expects derivative stacks "
                "batched on the leading axis")
        um = u_mask[0] if in_batched[7] else u_mask
        reg_v = reg if in_batched[8] else reg.expand(axis_size)
        return kern(fx, fu, gx, gu, gxx, guu, gux, um, reg_v)

    # the solver builds the recursion's kernels for its dims before its
    # first trip (core/solve.py::make_solve_fn)
    dispatch.riccati_kernels = True
    return dispatch
