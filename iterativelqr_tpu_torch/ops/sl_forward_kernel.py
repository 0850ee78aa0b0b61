"""Line-search rollout kernels K3 (scoring) and K4 (winner re-roll) and
their plain versions.

Counterpart of ``iterativelqr_tpu/ops/sl_forward_kernel.py``:

* ``score_rollout`` runs K3, the TPU kernel ``_score_kernel`` (entry
  ``make_score_rollout``): the complete AL objective of a block of
  candidates alpha_j = 0.5**j, j0 <= j < j0+nb, each a closed-loop rollout
  u = ubar + K (x - xbar) + alpha k, in one launch -> J [nb, B];
* ``winner_reroll`` runs K4, the TPU kernel ``_reroll_kernel`` (entry
  ``make_winner_reroll``): one rollout at a per-lane alpha [B] ->
  (xs [T,nx,B], us [T-1,nu,B], J [B], c [T,nc,B]).

Both read the solver's live batch-last arrays (``ops/sl_ops.py``).  CPU
tensors take the plain versions ``score_rollout_reference`` and
``winner_reroll_reference``: the rollout loops of ``SLOps.line_search``,
which the ``forward_kernel="scan"`` path calls directly.  CUDA tensors
launch the kernels of ``csrc/sl_forward.cu`` (or of a generated model's
library) or raise.

A CUDA kernel cannot run arbitrary torch user code, so the kernels run the
stage functions as device functions, found by ``device_model`` in two
steps, as JAX feeds the user's jaxprs into Pallas:

1. the registry of hand-written models (``csrc/sl_model_*.cuh``): a spec
   whose every stage type is one of a registered model's own function
   objects, by identity (car's and the quadrotor's are
   ``functools.partial``s of module functions over one problem's
   ``Parameters``), gets that model with its parameters;
2. any other stage-uniform spec (``kernel_eligible``) gets a model
   generated from its torch stage functions (``ops/device_functions.py``:
   traced, lowered to a scalar program, printed as a header and built into
   a library of its own at first use, ``_build.build_generated``).  Per-step
   parameters ``w`` [T, npar, B] stream through the kernels with the other
   step inputs.

A spec that neither serves (stages that differ across steps, or a stage
function the generator refuses: an op outside its whitelist, a branch on a
traced value, a data-dependent shape, a random op, sorting, a matrix
decomposition, another dtype) has no device model and keeps the loops;
``model_reason`` says why, and ``forward_kernel="pallas"`` raises with it.

The JAX module's ``reroll_fits`` is a VMEM budget rule of the TPU; a Hopper
kernel writes its outputs straight to device memory, so the rule has no
counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import weakref
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from .. import _build
from ..core.spec import ProblemSpec
from ..models import acrobot, car, cartpole, particle, pendulum, quadrotor
from . import device_functions as df
from .packed_backward import LaunchCounter, _check, ring_entry
from .packed_pipeline import map2

# every K3 / K4 launch, and those of a generated model's symbols
SCORE_LAUNCHES = LaunchCounter("sl_score_rollout")
REROLL_LAUNCHES = LaunchCounter("sl_winner_reroll")
GENERATED_SCORE_LAUNCHES = LaunchCounter("sl_score_rollout_generated")
GENERATED_REROLL_LAUNCHES = LaunchCounter("sl_winner_reroll_generated")

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_MAX_PARAMS = 16   # kMaxParams in csrc/sl_rollout.cuh


def map3(fn):
    """map2 plus a leading line-search-candidate axis on (x, u); w is shared
    across candidates."""
    return vmap(map2(fn), in_dims=(0, 0, None), out_dims=0)


def kernel_eligible(spec: ProblemSpec) -> bool:
    """True when one kernel body can serve every step of this spec: the
    dynamics, cost and constraint stage types and the inequality row are
    the same for every t < T-1."""
    Tm1 = spec.T - 1
    if Tm1 < 1:
        return False
    if len(np.unique(spec.dyn_tidx)) != 1:
        return False
    if len(np.unique(spec.cost_tidx[:Tm1])) != 1:
        return False
    if len(np.unique(spec.con_tidx[:Tm1])) != 1:
        return False
    if spec.nc > 0 and not (spec.ineq_mask[:Tm1] == spec.ineq_mask[0]).all():
        return False
    return True


# ---------------------------------------------------------------------------
# Device model registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """A spec's model on the device: ``name`` picks the C entry points,
    ``params`` are the floats its device functions read (cast to the
    solve's dtype in the kernel, as the torch functions cast them);
    ``generated`` is the generated model whose own library holds the
    entry points (None: a registered model, in the kernel library)."""

    name: str
    params: tuple = ()
    generated: Optional[df.GeneratedModel] = None


@dataclasses.dataclass(frozen=True)
class _Entry:
    """A registered model: its own stage functions (None = the empty
    constraint block), dims, and inequality rows of the stage and the
    terminal constraint."""

    name: str
    dyn: Callable
    cost: Callable
    cost_T: Callable
    con: Optional[Callable]
    con_T: Optional[Callable]
    nx: int
    nu: int
    nc: int
    ineq: tuple
    ineq_T: tuple


_REGISTRY = (
    _Entry("acrobot", acrobot.acrobot_discrete, acrobot.stage_cost,
           acrobot.terminal_cost, None, acrobot.goal_constraint,
           4, 1, 4, (), ()),
    # the goal dropped: pure iLQR, no constraint rows
    _Entry("acrobot_nc0", acrobot.acrobot_discrete, acrobot.stage_cost,
           acrobot.terminal_cost, None, None, 4, 1, 0, (), ()),
    _Entry("car", car.car_discrete, car.stage_cost, car.terminal_cost,
           car.stage_constraint, car.terminal_constraint,
           3, 2, 5, (0, 1, 2, 3, 4), (3,)),
    # thrust bounds on every stage; the terminal hover is an equality
    _Entry("quadrotor", quadrotor.quadrotor_discrete, quadrotor.stage_cost,
           quadrotor.terminal_cost, quadrotor.stage_constraint,
           quadrotor.terminal_constraint, 12, 4, 12, tuple(range(8)), ()),
    # linear dynamics; the terminal goal equality is the only constraint
    _Entry("particle", particle.particle_discrete, particle.stage_cost,
           particle.terminal_cost, None, particle.goal_constraint,
           2, 1, 2, (), ()),
    _Entry("pendulum", pendulum.pendulum_discrete, pendulum.stage_cost,
           pendulum.terminal_cost, None, pendulum.goal_constraint,
           2, 1, 2, (), ()),
    # control limits on every stage; the terminal upright is an equality
    _Entry("cartpole", cartpole.cartpole_discrete, cartpole.stage_cost,
           cartpole.terminal_cost, cartpole.stage_constraint,
           cartpole.terminal_constraint, 4, 1, 4, (0, 1), ()),
)

DEVICE_MODELS = tuple(sorted({e.name.split("_")[0] for e in _REGISTRY}))


def _base(f):
    """(function, the model's Parameters or None) of a stage object's
    callable."""
    if isinstance(f, functools.partial) and set(f.keywords) == {"p"} and not f.args:
        return f.func, f.keywords["p"]
    return f, None


def _rows(mask_row) -> tuple:
    return tuple(int(i) for i in np.nonzero(mask_row)[0])


def _registered(spec: ProblemSpec) -> Optional[DeviceModel]:
    """The registered model whose own functions make up every stage type
    of ``spec``, with its parameters; None when there is none."""
    if spec.npar != 0:
        return None
    objs = df.stage_objects(spec)
    if any(o.num_parameter != 0 or (o.f is not None and o.num_state != spec.nx)
           for o in objs):
        return None
    if objs[0].num_next_state != spec.nx:
        return None
    fns, params = zip(*(_base(o.f) for o in objs))
    for e in _REGISTRY:
        if not all(a is b for a, b in zip(
                fns, (e.dyn, e.cost, e.cost_T, e.con, e.con_T))):
            continue
        if (spec.nx, spec.nu, spec.nc) != (e.nx, e.nu, e.nc):
            continue
        if any(o.num_action != e.nu for o in objs[:2]):
            continue
        if e.nc and (_rows(spec.ineq_mask[0]) != e.ineq
                     or _rows(spec.ineq_mask[-1]) != e.ineq_T):
            continue
        bound = {p for p in params if p is not None}
        if len(bound) > 1:
            return None      # stage functions of two different problems
        flat = bound.pop().flat() if bound else ()
        return DeviceModel(e.name, tuple(float(v) for v in flat))
    return None


def _find_model(spec: ProblemSpec, device) -> tuple:
    """(device model or None, the reason) for a solve on ``device``."""
    if not spec.dyn_types:
        return None, "the spec has no stage objects"
    if not kernel_eligible(spec):
        return None, ("the dynamics, cost or constraint stage types or the "
                      "inequality rows differ across steps (kernel_eligible)")
    model = _registered(spec)
    if model is not None:
        return model, f"the registered model {model.name}"
    try:
        gen = df.generate(spec, device)
    except df.Refused as e:
        return None, f"no device functions: {e}"
    return DeviceModel(gen.name, (), gen), f"generated from the stage functions ({gen.name})"


# a spec's (model, reason) per device type, found once: tracing takes
# milliseconds a function
_RESOLVED = weakref.WeakKeyDictionary()


def _resolve(spec: ProblemSpec, device) -> tuple:
    kind = torch.device(device).type
    per_device = _RESOLVED.setdefault(spec, {})
    if kind not in per_device:
        per_device[kind] = _find_model(spec, torch.device(kind))
    return per_device[kind]


def device_model(spec: ProblemSpec, device="cpu") -> Optional[DeviceModel]:
    """The model on the device of a solve of ``spec`` on ``device``: the
    registered model whose own functions make up every stage type, else
    one generated from the stage functions (traced on ``device``, where
    their closed-over constants live); None when neither serves
    (``model_reason`` says why)."""
    return _resolve(spec, device)[0]


def model_reason(spec: ProblemSpec, device="cpu") -> str:
    """Why ``spec`` has the device model it has on ``device``, or none."""
    return _resolve(spec, device)[1]


def select_kernels(spec: ProblemSpec, options, device) -> bool:
    """Whether the Armijo line search runs K3/K4 rather than the loops:
    ``forward_kernel="pallas"`` always, raising where the kernels cannot
    serve the spec; ``"auto"`` on the card where they can; ``"scan"``
    never.  The reference's rule (``iterativelqr_tpu/ops/sl_ops.py``),
    with the card in place of the TPU."""
    mode = options.forward_kernel
    want = mode == "pallas" or (
        mode == "auto" and torch.device(device).type == "cuda")
    if not want or options.line_search != "armijo":
        return False
    # constraint-aware acceptance scores candidates by their max violation,
    # which the loops accumulate and the kernels do not emit
    viol_filter = options.constraint_aware_acceptance and spec.nc > 0
    eligible = device_model(spec, device) is not None and not viol_filter
    if not eligible and mode == "pallas":
        why = ("constraint_aware_acceptance=True" if viol_filter
               else model_reason(spec, device))
        raise ValueError(
            'forward_kernel="pallas" requires stage-uniform '
            "dynamics/cost/constraint dispatch "
            "(ops/sl_forward_kernel.kernel_eligible), a model with device "
            "functions (ops/sl_forward_kernel.device_model: registered, "
            f"{', '.join(DEVICE_MODELS)}, or generated from the stage "
            "functions: every op of ops/device_functions.WHITELIST lowers; a "
            "branch on a traced value, a data-dependent shape, a random op, "
            "sorting and matrix decompositions do not) and "
            "constraint_aware_acceptance=False (the kernels do not score "
            "per-candidate violations); "
            f"this spec: {why}"
        )
    return eligible


# ---------------------------------------------------------------------------
# Plain versions (PyTorch loops over t)
# ---------------------------------------------------------------------------


class Rollouts:
    """The line-search rollouts of one spec on one device: the spec's stage
    functions batched for the plain loops, their static per-step stage
    types, and the device model the kernels run (None when the spec has
    none; ``model_reason`` says why)."""

    def __init__(self, spec: ProblemSpec, device):
        Tm1 = spec.T - 1
        self.spec = spec
        self.device = torch.device(device)
        self.ineq_t = torch.as_tensor(spec.ineq_mask, device=self.device)
        self.cmask_t = torch.as_tensor(spec.c_mask, device=self.device)
        self.dyn2 = [map2(f) for f in spec.dyn_eval]
        self.cost2 = [map2(f) for f in spec.cost_eval]
        self.con2 = [map2(f) for f in spec.con_eval]
        self.dyn3 = [map3(f) for f in spec.dyn_eval]
        self.cost3 = [map3(f) for f in spec.cost_eval]
        self.con3 = [map3(f) for f in spec.con_eval]
        # static per-step stage types: the loops pick each step's function
        # in Python (the JAX scans switch on a traced index)
        self.td = [int(i) for i in spec.dyn_tidx]
        self.tg = [int(i) for i in spec.cost_tidx[:Tm1]]
        self.tc = [int(i) for i in spec.con_tidx[:Tm1]]
        self.gT = int(spec.cost_tidx[-1])
        self.cT = int(spec.con_tidx[-1])
        self._alphas = {}
        self._params = None

    @property
    def model(self) -> Optional[DeviceModel]:
        return device_model(self.spec, self.device)

    @property
    def model_reason(self) -> str:
        return model_reason(self.spec, self.device)

    def prepare(self):
        """Builds and loads the kernels of the device model now (a generated
        model's library is compiled at its first use), so that no solve's
        loop waits for nvcc.  Only on the card."""
        if self.device.type == "cuda" and self.model is not None:
            _library(self.model)

    def alphas(self, dtype, n: int) -> torch.Tensor:
        """alpha_j = 0.5**j for j < n (exact powers of two), on the device
        in ``dtype``."""
        a = self._alphas.get((dtype, n))
        if a is None:
            a = torch.tensor([math.ldexp(1.0, -j) for j in range(n)],
                             dtype=torch.float64).to(self.device, dtype)
            self._alphas[(dtype, n)] = a
        return a


def _al_step_term(c_t, lam, rho, iq, dim):
    """lam*c + 1/2 a rho c^2 summed over the constraint axis ``dim``, with
    a = 0 on inactive inequality rows (c < 0 and lam == 0)."""
    inactive = iq & (c_t < 0.0) & (lam == 0.0)
    a = (~inactive).to(c_t.dtype)
    return torch.sum(lam * c_t + 0.5 * a * rho * c_t * c_t, dim=dim)


def score_rollout_reference(r: Rollouts, j0, nb, xbar, ubar, ws, K, k,
                            duals, penalty, violation=False):
    """Plain version of K3: J [nb, B] of the candidates alpha_j,
    j0 <= j < j0+nb, scored in one loop over t with the candidate axis
    leading.  With ``violation`` it also returns each candidate's max
    violation V [nb, B] (the constraint-aware acceptance of
    ``SLOps.line_search``, which no kernel computes)."""
    spec = r.spec
    nc, nu, nx = spec.nc, spec.nu, spec.nx
    B = xbar.shape[-1]
    alphas = r.alphas(xbar.dtype, j0 + nb)[j0:]
    ineq_t = r.ineq_t
    x = xbar[0][None].expand(nb, nx, B)
    J = xbar.new_zeros((nb, B))
    V = xbar.new_zeros((nb, B)) if violation else None

    def viol(c_t, t):
        iq = ineq_t[t][None, :, None]
        v = torch.where(iq, torch.clamp(c_t, min=0.0), torch.abs(c_t))
        v = torch.where(r.cmask_t[t][None, :, None], v, torch.zeros_like(v))
        return torch.maximum(V, v.amax(dim=1))

    for t in range(spec.T - 1):
        dx = x - xbar[t][None]
        u = (
            ubar[t][None]
            + torch.sum(K[t][None] * dx[:, None], dim=2)
            + alphas[:, None, None] * k[t][None]
        )
        w = ws[t]
        J = J + r.cost3[r.tg[t]](x, u, w)
        if nc > 0:
            c_t = r.con3[r.tc[t]](x, u, w)   # [nb,nc,B]
            J = J + _al_step_term(
                c_t, duals[t][None], penalty[t][None],
                ineq_t[t][None, :, None], 1
            )
            if violation:
                V = viol(c_t, t)
        x = r.dyn3[r.td[t]](x, u, w)
    u0 = xbar.new_zeros((nb, nu, B))
    J = J + r.cost3[r.gT](x, u0, ws[-1])
    if nc > 0:
        cT = r.con3[r.cT](x, u0, ws[-1])
        J = J + _al_step_term(
            cT, duals[-1][None], penalty[-1][None],
            ineq_t[-1][None, :, None], 1
        )
        if violation:
            V = viol(cT, -1)
    return (J, V) if violation else J


def winner_reroll_reference(r: Rollouts, alpha, xbar, ubar, ws, K, k,
                            duals, penalty):
    """Plain version of K4: one closed-loop rollout at per-lane step size
    ``alpha`` [B] -> (xs [T,nx,B], us [T-1,nu,B], J [B], c [T,nc,B])."""
    spec = r.spec
    nc, nu = spec.nc, spec.nu
    B = xbar.shape[-1]
    ineq_t = r.ineq_t
    x = xbar[0]
    J = xbar.new_zeros(B)
    xs_l, us_l, cs_l = [], [], []
    for t in range(spec.T - 1):
        dx = x - xbar[t]
        u = ubar[t] + torch.sum(K[t] * dx[None], dim=1) + alpha[None] * k[t]
        w = ws[t]
        J = J + r.cost2[r.tg[t]](x, u, w)
        if nc > 0:
            c_t = r.con2[r.tc[t]](x, u, w)
            J = J + _al_step_term(
                c_t, duals[t], penalty[t], ineq_t[t][:, None], 0
            )
            cs_l.append(c_t)
        xs_l.append(x)
        us_l.append(u)
        x = r.dyn2[r.td[t]](x, u, w)
    u0 = xbar.new_zeros((nu, B))
    J = J + r.cost2[r.gT](x, u0, ws[-1])
    if nc > 0:
        cT = r.con2[r.cT](x, u0, ws[-1])
        J = J + _al_step_term(
            cT, duals[-1], penalty[-1], ineq_t[-1][:, None], 0
        )
        c = torch.stack(cs_l + [cT])
    else:
        c = xbar.new_zeros((spec.T, 0, B))
    xs = torch.stack(xs_l + [x])
    us = torch.stack(us_l)
    return xs, us, J, c


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _library(model: DeviceModel):
    """The library that holds the model's entry points."""
    if model.generated is None:
        return _build.load_library()
    return _build.load_generated(model.generated.translation_unit())


def _kernel_fn(kind: str, model: DeviceModel, dtype):
    symbol = f"sl_{kind}_{model.name}_{_DTYPES[dtype]}"
    fn = getattr(_library(model), symbol)
    if fn.argtypes is None:
        # score: xbar ubar ws K k duals penalty J | T B j0 nb | params stream
        # reroll: alpha xbar ubar ws K k duals penalty xs us J c | T B | params stream
        n_ptr = 8 if kind == "score" else 12
        n_int = 4 if kind == "score" else 2
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn, symbol


def rollout_ring(model: DeviceModel, dtype) -> tuple:
    """The ring of step tiles of K3 and K4 for a device model and dtype:
    (tiles, bytes of shared memory a block); (0, 0) for a model whose
    kernels load their step inputs in the step (``kStream`` false in its
    ``csrc/sl_model_*.cuh``, or the generated model's).  Builds the
    kernels on first use."""
    return ring_entry(f"sl_ring_{model.name}_{_DTYPES[dtype]}", lib=_library(model))


def _check_inputs(r: Rollouts, xbar, ubar, ws, K, k, duals, penalty):
    """Checks the device model and the live arrays' device, dtype, shape
    and contiguity; returns (dtype, T, B)."""
    spec = r.spec
    if r.model is None:
        raise ValueError(
            f"the rollout kernels have no device model for this spec: {r.model_reason}")
    device, dtype = xbar.device, xbar.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"rollout kernels take float32 or float64, not {dtype}")
    T, nx, nu, nc = spec.T, spec.nx, spec.nu, spec.nc
    B = xbar.shape[-1]
    for name, a, shape in (
        ("xbar", xbar, (T, nx, B)), ("ubar", ubar, (T - 1, nu, B)),
        ("ws", ws, (T, spec.npar, B)), ("K", K, (T - 1, nu, nx, B)),
        ("k", k, (T - 1, nu, B)), ("duals", duals, (T, nc, B)),
        ("penalty", penalty, (T, nc, B)),
    ):
        _check(name, a, shape, dtype, device)
    if r._params is None:
        params = r.model.params
        if len(params) > _MAX_PARAMS:
            raise ValueError(f"{len(params)} model parameters > {_MAX_PARAMS}")
        r._params = (ctypes.c_double * _MAX_PARAMS)(*params)
    return dtype, T, B


def score_rollout(r: Rollouts, j0: int, nb: int, xbar, ubar, ws, K, k,
                  duals, penalty):
    """K3: J [nb, B] of the candidates alpha_j = 0.5**j, j0 <= j < j0+nb.

    Inputs are the solver's live arrays: xbar [T,nx,B], ubar [T-1,nu,B],
    ws [T,npar,B], K [T-1,nu,nx,B], k [T-1,nu,B], duals/penalty [T,nc,B].
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream without synchronising, or raise.
    """
    device = xbar.device
    if device.type == "cpu":
        return score_rollout_reference(r, j0, nb, xbar, ubar, ws, K, k,
                                       duals, penalty)
    if device.type != "cuda":
        raise ValueError(f"score_rollout: unsupported device {device}")
    dtype, T, B = _check_inputs(r, xbar, ubar, ws, K, k, duals, penalty)
    J = torch.empty((nb, B), dtype=dtype, device=device)
    fn, symbol = _kernel_fn("score", r.model, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(xbar.data_ptr(), ubar.data_ptr(), ws.data_ptr(), K.data_ptr(),
                 k.data_ptr(), duals.data_ptr(), penalty.data_ptr(), J.data_ptr(),
                 T, B, int(j0), int(nb), ctypes.addressof(r._params), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err} "
                           f"(T={T}, B={B}, j0={j0}, nb={nb})")
    SCORE_LAUNCHES.launches += 1
    if r.model.generated is not None:
        GENERATED_SCORE_LAUNCHES.launches += 1
    return J


def winner_reroll(r: Rollouts, alpha, xbar, ubar, ws, K, k, duals, penalty):
    """K4: the rollout at per-lane step size ``alpha`` [B] -> (xs [T,nx,B],
    us [T-1,nu,B], J [B], c [T,nc,B]); inputs as ``score_rollout``."""
    device = xbar.device
    if device.type == "cpu":
        return winner_reroll_reference(r, alpha, xbar, ubar, ws, K, k,
                                       duals, penalty)
    if device.type != "cuda":
        raise ValueError(f"winner_reroll: unsupported device {device}")
    dtype, T, B = _check_inputs(r, xbar, ubar, ws, K, k, duals, penalty)
    _check("alpha", alpha, (B,), dtype, device)
    spec = r.spec
    xs = torch.empty((T, spec.nx, B), dtype=dtype, device=device)
    us = torch.empty((T - 1, spec.nu, B), dtype=dtype, device=device)
    J = torch.empty((B,), dtype=dtype, device=device)
    c = torch.empty((T, spec.nc, B), dtype=dtype, device=device)
    fn, symbol = _kernel_fn("reroll", r.model, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(alpha.data_ptr(), xbar.data_ptr(), ubar.data_ptr(),
                 ws.data_ptr(), K.data_ptr(), k.data_ptr(), duals.data_ptr(),
                 penalty.data_ptr(), xs.data_ptr(), us.data_ptr(),
                 J.data_ptr(), c.data_ptr(), T, B,
                 ctypes.addressof(r._params), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err} "
                           f"(T={T}, B={B})")
    REROLL_LAUNCHES.launches += 1
    if r.model.generated is not None:
        GENERATED_REROLL_LAUNCHES.launches += 1
    return xs, us, J, c
