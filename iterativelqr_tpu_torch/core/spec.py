"""Problem specification: user-facing Dynamics / Cost / Constraint plus the
padded ``ProblemSpec`` the solver core consumes.

Counterpart of ``iterativelqr_tpu/core/spec.py``.  User functions are plain
per-instance PyTorch functions of ``(x, u[, w])`` on 1-D tensors;
derivatives come from ``torch.func`` (``jacfwd``, ``grad``, ``jacfwd`` of
``grad``), and the solver batches them with ``torch.func.vmap``.  Per-timestep
dimensions are padded to the horizon maximum with boolean masks, and distinct
per-timestep functions become a small set of stage types grouped by semantic
identity.  Manual derivative callables replace autodiff where given.  The
dynamics second derivatives (``hess_fn``, used only by ``Options.ddp``) are
``jacfwd`` of the dynamics Jacobian function, so manual user Jacobians are
honoured.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, jacfwd


def _normalize_fn(f: Callable, num_parameter: int) -> Callable:
    """Return a (x, u, w) -> out callable regardless of the user signature
    (reference functions take (x, u) when num_parameter == 0)."""
    if num_parameter > 0:
        return f
    return lambda x, u, w: f(x, u)


def _probe_size(fn, n, m, p) -> int:
    """Output size of ``fn`` on zero inputs, evaluated on fake tensors as
    the JAX package uses ``jax.eval_shape``: nothing runs, so closed-over
    constants may live on any device.  The inputs go on the CPU first,
    then on each device a tensor of the failed attempt lived on.  A
    function no fake attempt takes (a branch on a value) runs once on CPU
    zeros."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _Devices(TorchDispatchMode):
        def __init__(self, seen):
            super().__init__()
            self.seen = seen

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for a in tree_leaves((args, kwargs)):
                if isinstance(a, torch.Tensor) and a.device not in self.seen:
                    self.seen.append(a.device)
            return func(*args, **(kwargs or {}))

    devices = [torch.device("cpu")]
    for d in devices:  # grows while it runs
        z = lambda k: torch.zeros(k, dtype=torch.float64, device=d)
        try:
            with FakeTensorMode(allow_non_fake_inputs=True), _Devices(devices):
                return int(fn(z(n), z(m), z(p)).numel())
        except Exception:  # noqa: BLE001 -- the next device, or the CPU run below
            pass
    z = lambda k: torch.zeros(k, dtype=torch.float64)
    return int(fn(z(n), z(m), z(p)).numel())


class Dynamics:
    """Discrete-time dynamics x' = f(x, u[, w]) for one timestep
    (reference: src/dynamics.jl:1-34, manual Jacobians :55-60)."""

    def __init__(
        self,
        f: Callable,
        num_state: int,
        num_action: int,
        num_parameter: int = 0,
        *,
        num_next_state: Optional[int] = None,
        jacobian_state: Optional[Callable] = None,
        jacobian_action: Optional[Callable] = None,
    ):
        self.f = f
        self.num_state = int(num_state)
        self.num_action = int(num_action)
        self.num_parameter = int(num_parameter)
        self._fn = _normalize_fn(f, self.num_parameter)
        if num_next_state is None:
            num_next_state = _probe_size(
                self._fn, self.num_state, self.num_action, self.num_parameter
            )
        self.num_next_state = int(num_next_state)
        self.jacobian_state = (
            _normalize_fn(jacobian_state, self.num_parameter) if jacobian_state else None
        )
        self.jacobian_action = (
            _normalize_fn(jacobian_action, self.num_parameter) if jacobian_action else None
        )

    def __call__(self, x, u, w=None):
        w = x.new_zeros(self.num_parameter) if w is None else w
        return self._fn(x, u, w)

    def _group_key(self):
        return (
            Dynamics, id(self.f), self.num_state, self.num_action,
            self.num_parameter, self.num_next_state,
            id(self.jacobian_state), id(self.jacobian_action),
        )


class Cost:
    """Stage cost g(x, u[, w]) -> scalar (reference: src/costs.jl:17-44).
    Optional manual gradient/Hessian callables replace autodiff."""

    def __init__(
        self,
        f: Callable,
        num_state: int,
        num_action: int,
        num_parameter: int = 0,
        *,
        gradient_state: Optional[Callable] = None,
        gradient_action: Optional[Callable] = None,
        hessian_state_state: Optional[Callable] = None,
        hessian_action_action: Optional[Callable] = None,
        hessian_action_state: Optional[Callable] = None,
    ):
        self.f = f
        self.num_state = int(num_state)
        self.num_action = int(num_action)
        self.num_parameter = int(num_parameter)
        self._fn = _normalize_fn(f, self.num_parameter)
        manual = (
            gradient_state,
            gradient_action,
            hessian_state_state,
            hessian_action_action,
            hessian_action_state,
        )
        if any(m is not None for m in manual) and not all(m is not None for m in manual):
            raise ValueError("provide all five manual derivative functions or none")
        self.manual = (
            tuple(_normalize_fn(m, self.num_parameter) for m in manual)
            if manual[0] is not None
            else None
        )

    def __call__(self, x, u, w=None):
        w = x.new_zeros(self.num_parameter) if w is None else w
        return self._fn(x, u, w)

    def _group_key(self):
        return (
            Cost, id(self.f), self.num_state, self.num_action,
            self.num_parameter,
            tuple(id(m) for m in self.manual) if self.manual else None,
        )


class Constraint:
    """Constraint block c(x, u[, w]) with mixed equality/inequality rows
    (reference: src/constraints.jl:17-43).  Rows in ``indices_inequality``
    (0-based) are c <= 0, all others c == 0; ``Constraint()`` is the empty
    block."""

    def __init__(
        self,
        f: Optional[Callable] = None,
        num_state: int = 0,
        num_action: int = 0,
        num_parameter: int = 0,
        *,
        indices_inequality: Sequence[int] = (),
        num_constraint: Optional[int] = None,
        jacobian_state: Optional[Callable] = None,
        jacobian_action: Optional[Callable] = None,
    ):
        self.f = f
        self.num_state = int(num_state)
        self.num_action = int(num_action)
        self.num_parameter = int(num_parameter)
        self.indices_inequality = tuple(int(i) for i in indices_inequality)
        if f is None:
            self._fn = None
            self.num_constraint = 0
        else:
            self._fn = _normalize_fn(f, self.num_parameter)
            if num_constraint is None:
                num_constraint = _probe_size(
                    self._fn, self.num_state, self.num_action,
                    self.num_parameter,
                )
            self.num_constraint = int(num_constraint)
        for i in self.indices_inequality:
            if not 0 <= i < max(self.num_constraint, 1):
                raise ValueError(f"inequality index {i} out of range")
        self.jacobian_state = (
            _normalize_fn(jacobian_state, self.num_parameter) if jacobian_state else None
        )
        self.jacobian_action = (
            _normalize_fn(jacobian_action, self.num_parameter) if jacobian_action else None
        )

    def __call__(self, x, u, w=None):
        if self._fn is None:
            return x.new_zeros(0)
        w = x.new_zeros(self.num_parameter) if w is None else w
        return self._fn(x, u, w)

    def _group_key(self):
        # every empty block is the same stage type (f is None)
        return (
            Constraint, id(self.f), self.num_state, self.num_action,
            self.num_parameter, self.indices_inequality,
            self.num_constraint,
            id(self.jacobian_state), id(self.jacobian_action),
        )


# ---------------------------------------------------------------------------
# Padded wrappers
# ---------------------------------------------------------------------------


def _pad_to(v, size):
    v = v.reshape(-1)
    n = v.shape[0]
    if n == size:
        return v
    return torch.cat([v, v.new_zeros(size - n)])


def _pad2(m, rows, cols):
    r, c = m.shape
    if (r, c) == (rows, cols):
        return m
    return torch.nn.functional.pad(m, (0, cols - c, 0, rows - r))


def _like(x, *outs):
    """Derivatives in the dtype of the input: functorch's forward mode can
    carry a 0-d float32 tangent through a Python-float product in float64."""
    return tuple(o.to(x.dtype) for o in outs)


def _wrap_dyn(d: Dynamics, nx: int, nu: int, npar: int):
    """padded (x,u,w) -> padded next state, its Jacobians and its second
    derivatives."""
    n, m, p, ny = d.num_state, d.num_action, d.num_parameter, d.num_next_state

    def eval_fn(x, u, w):
        y = d._fn(x[:n], u[:m], w[:p])
        return _pad_to(y, nx)

    if d.jacobian_state is not None and d.jacobian_action is not None:
        def jac_fn(x, u, w):
            fx = _pad2(d.jacobian_state(x[:n], u[:m], w[:p]).reshape(ny, n), nx, nx)
            fu = _pad2(d.jacobian_action(x[:n], u[:m], w[:p]).reshape(ny, m), nx, nu)
            return fx, fu
    else:
        def jac_fn(x, u, w):
            fx = jacfwd(eval_fn, argnums=0)(x, u, w)
            fu = jacfwd(eval_fn, argnums=1)(x, u, w)
            return _like(x, fx, fu)

    def hess_fn(x, u, w):
        """Second derivatives of the dynamics for full DDP (``Options.ddp``;
        the reference's Gauss-Newton iLQR never forms these):
        fxx[i,a,b] = d2 f_i / dx_a dx_b, fuu[i,a,b] = d2 f_i / du_a du_b,
        fux[i,a,b] = d2 f_i / du_a dx_b.  Differentiates ``jac_fn``, so
        manual user Jacobians are honoured; padded dims carry exact zeros
        by construction."""
        fxx, fux = jacfwd(jac_fn, argnums=0)(x, u, w)
        _, fuu = jacfwd(jac_fn, argnums=1)(x, u, w)
        return _like(x, fxx, fuu, fux)

    return eval_fn, jac_fn, hess_fn


def _wrap_cost(g: Cost, nx: int, nu: int, npar: int):
    n, m, p = g.num_state, g.num_action, g.num_parameter

    def eval_fn(x, u, w):
        return g._fn(x[:n], u[:m], w[:p]).reshape(())

    if g.manual is not None:
        gs, ga, hss, haa, has_ = g.manual

        def grad_fn(x, u, w):
            gx = _pad_to(gs(x[:n], u[:m], w[:p]), nx)
            gu = _pad_to(ga(x[:n], u[:m], w[:p]), nu)
            return gx, gu

        def hess_fn(x, u, w):
            gxx = _pad2(hss(x[:n], u[:m], w[:p]).reshape(n, n), nx, nx)
            guu = _pad2(haa(x[:n], u[:m], w[:p]).reshape(m, m), nu, nu)
            gux = _pad2(has_(x[:n], u[:m], w[:p]).reshape(m, n), nu, nx)
            return gxx, guu, gux
    else:
        # torch.func.grad returns exact zeros for an argument the function
        # does not use (a terminal cost with num_action=0 sees u[:0])
        def grad_fn(x, u, w):
            gx = grad(eval_fn, argnums=0)(x, u, w)
            gu = grad(eval_fn, argnums=1)(x, u, w)
            return _like(x, gx, gu)

        def hess_fn(x, u, w):
            gxx = jacfwd(grad(eval_fn, argnums=0), argnums=0)(x, u, w)
            guu = jacfwd(grad(eval_fn, argnums=1), argnums=1)(x, u, w)
            gux = jacfwd(grad(eval_fn, argnums=1), argnums=0)(x, u, w)
            return _like(x, gxx, guu, gux)

    return eval_fn, grad_fn, hess_fn


def _wrap_con(c: Constraint, nx: int, nu: int, npar: int, nc: int):
    n, m, p, k = c.num_state, c.num_action, c.num_parameter, c.num_constraint

    if c._fn is None:
        def eval_fn(x, u, w):
            return x.new_zeros((nc,))

        def jac_fn(x, u, w):
            return x.new_zeros((nc, nx)), x.new_zeros((nc, nu))

        return eval_fn, jac_fn

    def eval_fn(x, u, w):
        return _pad_to(c._fn(x[:n], u[:m], w[:p]), nc)

    if c.jacobian_state is not None and c.jacobian_action is not None:
        def jac_fn(x, u, w):
            cx = _pad2(c.jacobian_state(x[:n], u[:m], w[:p]).reshape(k, n), nc, nx)
            cu = _pad2(c.jacobian_action(x[:n], u[:m], w[:p]).reshape(k, m), nc, nu)
            return cx, cu
    else:
        def jac_fn(x, u, w):
            cx = jacfwd(eval_fn, argnums=0)(x, u, w)
            cu = jacfwd(eval_fn, argnums=1)(x, u, w)
            return _like(x, cx, cu)

    return eval_fn, jac_fn


# ---------------------------------------------------------------------------
# Stage-type grouping
# ---------------------------------------------------------------------------


def _group(objs):
    """Group a per-timestep list by semantic stage-type identity
    (``_group_key``).  Returns (unique_objs, type_index ndarray
    [len(objs)], groups: list of ndarray timestep indices per type)."""
    uniq, tidx = [], np.zeros(len(objs), dtype=np.int32)
    ids = {}
    for t, o in enumerate(objs):
        key = o._group_key() if hasattr(o, "_group_key") else id(o)
        if key not in ids:
            ids[key] = len(uniq)
            uniq.append(o)
        tidx[t] = ids[key]
    groups = [np.nonzero(tidx == k)[0] for k in range(len(uniq))]
    return uniq, tidx, groups


@dataclasses.dataclass(frozen=True, eq=False)
class ProblemSpec:
    """Padded problem description: per-type wrapped callables, static
    grouping, and numpy masks."""

    T: int  # horizon: T states, T-1 actions
    nx: int
    nu: int
    nc: int
    npar: int

    dyn_eval: tuple
    dyn_jac: tuple
    dyn_hess: tuple  # second derivatives (Options.ddp)
    dyn_tidx: np.ndarray  # [T-1]
    dyn_groups: tuple

    cost_eval: tuple
    cost_grad: tuple
    cost_hess: tuple
    cost_tidx: np.ndarray  # [T]
    cost_groups: tuple

    con_eval: tuple
    con_jac: tuple
    con_tidx: np.ndarray  # [T]
    con_groups: tuple

    x_dims: np.ndarray  # [T]
    u_dims: np.ndarray  # [T-1]
    c_dims: np.ndarray  # [T]
    x_mask: np.ndarray  # [T, nx] bool
    u_mask: np.ndarray  # [T-1, nu] bool
    c_mask: np.ndarray  # [T, nc] bool
    ineq_mask: np.ndarray  # [T, nc] bool

    # the user's stage object of each type index (one per entry of the
    # *_eval tuples); the rollout kernels recognise registered models by
    # their functions (ops/sl_forward_kernel.py::device_model)
    dyn_types: tuple = ()
    cost_types: tuple = ()
    con_types: tuple = ()


def build_spec(
    dynamics: Sequence[Dynamics],
    costs: Sequence[Cost],
    constraints: Optional[Sequence[Constraint]] = None,
) -> ProblemSpec:
    """Build a padded ProblemSpec from per-timestep lists: ``dynamics`` has
    T-1 entries, ``costs`` T, ``constraints`` (optional) T
    (reference: src/solver.jl:11-46)."""
    dynamics = list(dynamics)
    costs = list(costs)
    T = len(dynamics) + 1
    if len(costs) != T:
        raise ValueError(f"expected {T} costs, got {len(costs)}")
    if constraints is None:
        constraints = [Constraint() for _ in range(T)]
    constraints = list(constraints)
    if len(constraints) != T:
        raise ValueError(f"expected {T} constraints, got {len(constraints)}")

    x_dims = np.array(
        [dynamics[0].num_state]
        + [dynamics[t].num_state for t in range(1, T - 1)]
        + [dynamics[-1].num_next_state],
        dtype=np.int32,
    )
    for t in range(T - 2):
        if dynamics[t].num_next_state != dynamics[t + 1].num_state:
            raise ValueError(
                f"dynamics[{t}].num_next_state={dynamics[t].num_next_state} != "
                f"dynamics[{t+1}].num_state={dynamics[t+1].num_state}"
            )
    u_dims = np.array([d.num_action for d in dynamics], dtype=np.int32)
    c_dims = np.array([c.num_constraint for c in constraints], dtype=np.int32)

    nx = int(x_dims.max())
    nu = int(u_dims.max()) if len(u_dims) else 0
    nc = int(c_dims.max()) if len(c_dims) else 0
    npar = int(
        max(
            [d.num_parameter for d in dynamics]
            + [g.num_parameter for g in costs]
            + [c.num_parameter for c in constraints]
            + [0]
        )
    )

    def mask(dims, width, rows):
        m = np.zeros((rows, width), dtype=bool)
        for t in range(rows):
            m[t, : dims[t]] = True
        return m

    ineq_mask = np.zeros((T, nc), dtype=bool)
    for t, c in enumerate(constraints):
        for i in c.indices_inequality:
            ineq_mask[t, i] = True

    d_uniq, d_tidx, d_groups = _group(dynamics)
    g_uniq, g_tidx, g_groups = _group(costs)
    c_uniq, c_tidx, c_groups = _group(constraints)

    dyn_wrapped = [_wrap_dyn(d, nx, nu, npar) for d in d_uniq]
    cost_wrapped = [_wrap_cost(g, nx, nu, npar) for g in g_uniq]
    con_wrapped = [_wrap_con(c, nx, nu, npar, nc) for c in c_uniq]

    return ProblemSpec(
        T=T,
        nx=nx,
        nu=nu,
        nc=nc,
        npar=npar,
        dyn_eval=tuple(w[0] for w in dyn_wrapped),
        dyn_jac=tuple(w[1] for w in dyn_wrapped),
        dyn_hess=tuple(w[2] for w in dyn_wrapped),
        dyn_tidx=d_tidx,
        dyn_groups=tuple(d_groups),
        cost_eval=tuple(w[0] for w in cost_wrapped),
        cost_grad=tuple(w[1] for w in cost_wrapped),
        cost_hess=tuple(w[2] for w in cost_wrapped),
        cost_tidx=g_tidx,
        cost_groups=tuple(g_groups),
        con_eval=tuple(w[0] for w in con_wrapped),
        con_jac=tuple(w[1] for w in con_wrapped),
        con_tidx=c_tidx,
        con_groups=tuple(c_groups),
        x_dims=x_dims,
        u_dims=u_dims,
        c_dims=c_dims,
        x_mask=mask(x_dims, nx, T),
        u_mask=mask(u_dims, nu, T - 1),
        c_mask=mask(c_dims, nc, T),
        ineq_mask=ineq_mask,
        dyn_types=tuple(d_uniq),
        cost_types=tuple(g_uniq),
        con_types=tuple(c_uniq),
    )
