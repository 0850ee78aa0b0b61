"""The derive kernel: the stage functions' Jacobians, gradients and Hessians
at every (lane, stage) in one launch (``csrc/sl_derive.cuh``).

The SL loop's derive (``ops/packed_pipeline.py::make_derive_backward_sl``)
evaluates at each stage t < T-1 and lane b the dynamics Jacobians fx, fu,
the stage cost's gradient gx, gu and Hessian gxx, guu, gux and the
constraint Jacobians cx, cu; at the terminal stage, with u = 0, the
terminal cost's gx, gxx and the terminal constraint's cx.  Its plain
version vmaps ``core/spec.py``'s ``torch.func`` compositions (``jacfwd``,
``grad``, a user's manual derivatives) over t and over the lanes.  The JAX
package leaves this to XLA, which fuses it: no Pallas kernel computes it,
so the kernel replaces none.

Here the same functions are traced once (``ops/device_functions.py::
trace``; jacfwd's and grad's graphs have fixed shapes) into two scalar
programs, the stage's and the terminal stage's, whose outputs are the
stacks' entries in order, so the work they share (the dynamics' chain, a
sin or cos) is done once.  They are printed as a header, built with the
kernel body into a library of their own at first use (cached by its text,
as K3/K4's generated models are), and launched over B x T threads.

A spec whose stages are one combined type and whose two programs lower has
a derive model (``derive_model``); ``derive_reason`` says why one has none.
On the card the pipeline takes the kernel for such a spec and the plain
version for any other (counted on ``derive.plain``); off the card, always
the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import weakref
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..core.spec import ProblemSpec
from ..utils.profiling import LaunchCounter
from . import device_functions as df
from .packed_backward import _check

# every kernel launch; every derive on the card that took the plain version
DERIVE_LAUNCHES = LaunchCounter("sl_derive")
PLAIN_DERIVES = LaunchCounter("derive.plain")

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
# the stacks in the kernel's order (its stack index k); gx, gxx and cx have
# a terminal row (T rows), the others T-1
STACKS = ("fx", "fu", "gx", "gu", "gxx", "guu", "gux", "cx", "cu")
TERMINAL = ("gx", "gxx", "cx")
MAX_HORIZON = 65535     # the grid's y dimension is the stage


def stack_dims(nx: int, nu: int, nc: int) -> dict:
    """Each stack's entries a (lane, stage), by name."""
    return {"fx": (nx, nx), "fu": (nx, nu), "gx": (nx,), "gu": (nu,), "gxx": (nx, nx),
            "guu": (nu, nu), "gux": (nu, nx), "cx": (nc, nx), "cu": (nc, nu)}


def stack_names(nc: int) -> tuple:
    """The stacks a derive gives: cx and cu only where there are constraint
    rows."""
    return STACKS if nc > 0 else STACKS[:7]


def terminal_names(nc: int) -> tuple:
    """The stacks the terminal stage writes a row of."""
    return TERMINAL if nc > 0 else TERMINAL[:2]


def combined_key(spec: ProblemSpec) -> np.ndarray:
    """The (dynamics, cost, constraint) stage type of each t < T-1 as one
    integer."""
    Tm1 = spec.T - 1
    n_cost, n_con = len(spec.cost_eval), len(spec.con_eval)
    return ((spec.dyn_tidx.astype(np.int64) * n_cost + spec.cost_tidx[:Tm1]) * n_con
            + spec.con_tidx[:Tm1])


def stage_function(spec: ProblemSpec, key: int):
    """The stage's derivatives of one combined key: (x, u, w) -> (fx, fu,
    gx, gu, gxx, guu, gux[, cx, cu]), the padded spec functions'."""
    n_cost, n_con = len(spec.cost_eval), len(spec.con_eval)
    di, rest = divmod(int(key), n_cost * n_con)
    gi, ci = divmod(rest, n_con)
    dj, cg, ch, cj = spec.dyn_jac[di], spec.cost_grad[gi], spec.cost_hess[gi], spec.con_jac[ci]
    nc = spec.nc

    def per_t(x, u, w):
        fx, fu = dj(x, u, w)
        gx, gu = cg(x, u, w)
        gxx, guu, gux = ch(x, u, w)
        if nc > 0:
            cx, cu = cj(x, u, w)
            return fx, fu, gx, gu, gxx, guu, gux, cx, cu
        return fx, fu, gx, gu, gxx, guu, gux

    return per_t


def terminal_function(spec: ProblemSpec):
    """The terminal stage's derivatives: (x, u, w) -> (gx, gxx[, cx]) of the
    terminal cost and constraint (called with u = 0)."""
    gT, cT = int(spec.cost_tidx[-1]), int(spec.con_tidx[-1])
    grad, hess, cjac = spec.cost_grad[gT], spec.cost_hess[gT], spec.con_jac[cT]
    nc = spec.nc

    def per_T(x, u, w):
        gx, _ = grad(x, u, w)
        gxx, _, _ = hess(x, u, w)
        if nc > 0:
            cx, _ = cjac(x, u, w)
            return gx, gxx, cx
        return gx, gxx

    return per_T


def _flat(fn):
    """``fn``'s outputs as one vector, in order."""
    return lambda x, u, w: torch.cat([a.reshape(-1) for a in fn(x, u, w)])


@dataclasses.dataclass(frozen=True)
class DeriveModel:
    """A spec's derivative programs (the stage's and the terminal stage's),
    its dims and the printed header; ``name`` keys its C symbols."""

    stage: df.Program
    terminal: df.Program
    nx: int
    nu: int
    nw: int
    nc: int
    header: str
    name: str

    def translation_unit(self, dtype) -> str:
        """The CUDA source of the kernel in ``dtype`` on this model: the
        header, the kernel body and its C entry point."""
        struct = "Derive_" + self.name[len("derive_"):]
        return (self.header + '\n#include "sl_derive.cuh"\n\n'
                + f"DERIVE_ENTRY({self.name}_{_DTYPES[dtype]}, sl_models::{struct}, "
                + f"{'float' if dtype == torch.float32 else 'double'})\n")


def _stores(prog: df.Program, names, dims) -> list:
    """The program's outputs as stores ``out(k, j, value)``: entry j of the
    stack of index k."""
    lines, outs = [], iter(prog.outs)
    for name in names:
        k = STACKS.index(name)
        lines += [f"    out({k}, {j}, {df.c_ref(prog, next(outs))});"
                  for j in range(math.prod(dims[name]))]
    return lines


def print_header(stage, terminal, nx, nu, nw, nc, struct: str) -> str:
    """The header of a derive model: the two programs as
    ``template <typename T, typename O> __host__ __device__`` functions that
    hand each entry to ``out(k, j, value)``."""
    dims = stack_dims(nx, nu, nc)
    names = stack_names(nc)
    return "\n".join([
        "// Derivative programs generated by iterativelqr_tpu_torch/ops/derive_kernel.py",
        "// from a problem's stage functions and their torch.func derivatives, for",
        "// the derive kernel (sl_derive.cuh): the traced function's scalar program,",
        "// its operations in the traced order, literals cast to T.",
        *df.PREAMBLE,
        f"struct {struct} {{",
        f"  static constexpr int NX = {nx}, NU = {nu}, NW = {nw}, NC = {nc};",
        "",
        *df.HELPERS,
        "",
        "  // fx, fu, gx, gu, gxx, guu, gux[, cx, cu] of a stage",
        "  template <typename T, typename O>",
        "  __host__ __device__ static void stage(const T* x, const T* u, const T* w, const O& out) {",
        *df.c_statements(stage),
        *_stores(stage, names, dims),
        "  }",
        "",
        "  // gx, gxx[, cx] of the terminal stage (u = 0)",
        "  template <typename T, typename O>",
        "  __host__ __device__ static void terminal(const T* x, const T* w, const O& out) {",
        *df.c_statements(terminal),
        *_stores(terminal, terminal_names(nc), dims),
        "  }",
        "};",
        "",
        "}  // namespace sl_models",
        "",
    ])


def generate(spec: ProblemSpec, device="cpu") -> DeriveModel:
    """The derive model of ``spec`` solved on ``device`` (where the stage
    functions' closed-over constants live); raises ``df.Refused``."""
    if spec.T < 2:
        raise df.Refused("a horizon of one state has no stage")
    if spec.T > MAX_HORIZON:
        raise df.Refused(f"a horizon past {MAX_HORIZON} stages (the kernel's grid)")
    keys = np.unique(combined_key(spec))
    if len(keys) != 1:
        raise df.Refused("the dynamics, cost or constraint stage types differ across steps")
    nx, nu, nw, nc = spec.nx, spec.nu, spec.npar, spec.nc
    dims = stack_dims(nx, nu, nc)
    names = stack_names(nc)
    progs = []
    for what, fn, terminal, want in (
            ("stage", stage_function(spec, keys[0]), False, names),
            ("terminal stage", terminal_function(spec), True, terminal_names(nc))):
        try:
            p = df.trace(_flat(fn), nx, nu, nw, terminal=terminal, device=device)
        except df.Refused as e:
            raise df.Refused(f"{what}: {e}") from None
        n = sum(math.prod(dims[k]) for k in want)
        if len(p.outs) != n:
            raise df.Refused(f"the {what} gives {len(p.outs)} values, not {n}")
        progs.append(p)
    body = print_header(*progs, nx, nu, nw, nc, struct="Generated")
    digest = hashlib.sha256(body.encode()).hexdigest()[:16]
    return DeriveModel(*progs, nx, nu, nw, nc,
                       header=body.replace("struct Generated {", f"struct Derive_{digest} {{"),
                       name=f"derive_{digest}")


# a spec's (model, reason) per device type, found once
_RESOLVED = weakref.WeakKeyDictionary()


def _resolve(spec: ProblemSpec, device) -> tuple:
    kind = torch.device(device).type
    per_device = _RESOLVED.setdefault(spec, {})
    if kind not in per_device:
        try:
            model = generate(spec, torch.device(kind))
            per_device[kind] = model, f"generated from the stage functions ({model.name})"
        except df.Refused as e:
            per_device[kind] = None, f"no derive programs: {e}"
    return per_device[kind]


def derive_model(spec: ProblemSpec, device="cpu") -> Optional[DeriveModel]:
    """The derive model of a solve of ``spec`` on ``device``, or None
    (``derive_reason`` says why)."""
    return _resolve(spec, device)[0]


def derive_reason(spec: ProblemSpec, device="cpu") -> str:
    """Why ``spec`` has the derive model it has on ``device``, or none."""
    return _resolve(spec, device)[1]


def library(model: DeriveModel, dtype) -> ctypes.CDLL:
    """The kernel's library on ``model`` in ``dtype``, built at its first
    use and loaded once per process."""
    return _build.load_generated(model.translation_unit(dtype))


def derive_stacks(model: DeriveModel, xs, us, ws) -> tuple:
    """The kernel: xs [T,nx,B], us [T-1,nu,B], ws [T,nw,B] on the card ->
    (fx, fu, gx, gu, gxx, guu, gux[, cx, cu]) batch-last, gx, gxx and cx
    with T rows (the terminal stage's last), the others T-1; padded rows
    are zero.  Launches on the current stream of the inputs' device without
    synchronising; raises on a CUDA error."""
    device, dtype = xs.device, xs.dtype
    if device.type != "cuda":
        raise ValueError(f"derive_stacks: the kernel runs on the card, not {device}")
    if dtype not in _DTYPES:
        raise ValueError(f"the derive kernel takes float32 or float64, not {dtype}")
    T, B = xs.shape[0], xs.shape[-1]
    for name, a, shape in (("xs", xs, (T, model.nx, B)), ("us", us, (T - 1, model.nu, B)),
                           ("ws", ws, (T, model.nw, B))):
        _check(name, a, shape, dtype, device)
    dims = stack_dims(model.nx, model.nu, model.nc)
    names = stack_names(model.nc)
    outs = [torch.empty((T if n in TERMINAL else T - 1, *dims[n], B), dtype=dtype,
                        device=device) for n in names]
    ptrs = (ctypes.c_void_p * len(STACKS))(*(o.data_ptr() for o in outs))
    symbol = f"sl_derive_{model.name}_{_DTYPES[dtype]}"
    fn = getattr(library(model, dtype), symbol)
    if fn.argtypes is None:
        # xs us ws | stacks | T B | stream
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(xs.data_ptr(), us.data_ptr(), ws.data_ptr(), ptrs, T, B, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err} (T={T}, B={B})")
    DERIVE_LAUNCHES.launches += 1
    return tuple(outs)
