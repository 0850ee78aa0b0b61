"""Device functions generated from a user's torch stage functions, for the
line-search rollout kernels K3/K4 (``csrc/sl_rollout.cuh``).

Counterpart of ``_Fns`` and ``_eval_jaxpr_no_dot`` in
``iterativelqr_tpu/ops/sl_forward_kernel.py``: there the user's stage
functions become jaxprs whose closed-over constants are hoisted into kernel
arguments, and the jaxpr is evaluated inside the Pallas body, every
``dot_general`` rewritten as multiply-reduce.  Here each of the five stage
objects the kernels call (dynamics, stage cost, terminal cost, stage
constraint, terminal constraint) is

1. **traced** with ``make_fx(functionalize(fn), tracing_mode="fake")`` on
   f64 inputs ``(x [num_state], u [num_action], w [num_parameter])``: an
   aten graph whose writes into tensors are out-of-place ops
   (``select_scatter``, ``slice_scatter``, ``index_put``);
2. **lowered** to a scalar program, a straight-line list of scalar
   operations over numbered registers.  Shapes are fixed, so:

   * layout ops only rename registers: ``select``, ``slice``, ``view``,
     ``unsqueeze``, ``squeeze``, ``permute``, ``t``/``transpose``,
     ``expand``, ``repeat``, ``flip``, ``diagonal``, ``stack``, ``cat``,
     ``unbind``, ``split``;
   * indexing with constant integer indices renames too: ``index`` (a
     closed-over LongTensor or a Python list), ``index_select``,
     ``gather``; so do writes at constant indices (``index_put``,
     ``select_scatter``, ``slice_scatter``, ``copy``) and the constant
     makers (``zeros``, ``ones``, ``full``, ``eye``, ``arange``, their
     ``_like`` and ``new_`` forms, ``fill``, ``diag_embed``).  An integer
     value is taken only as an index;
   * products unroll into multiply-adds, left to right: ``dot``, ``mv``,
     ``mm``, ``bmm``, ``addmm``, ``linalg_cross`` (JAX's ``_dot_mulsum``
     rule: a tiny product is multiply-reduce, never a library call);
   * reductions unroll left to right: ``sum``, ``prod``, ``mean``,
     ``amax``/``amin``/``max``/``min`` (NaN propagates, as in torch) and
     ``linalg_vector_norm`` at any ord > 0 and at +-inf;
   * elementwise math becomes one scalar op each: + - * /, the
     comparisons and logic of ``where`` and ``clamp``, ``minimum``,
     ``maximum``, ``abs``, ``sign``, ``relu``, ``sqrt``, ``rsqrt``,
     ``reciprocal``, ``exp``, ``expm1``, ``log``, ``log1p``, the
     trigonometric and hyperbolic functions and their inverses,
     ``atan2``, ``hypot``, ``erf``, ``sigmoid``, ``softplus`` (torch's
     ``x * beta > threshold ? x : log1p(exp(x * beta)) / beta``) and
     ``pow`` (torch's products for the exponents it forms from them,
     ``pow(x, e)`` for any other);

   a closed-over tensor becomes literals (``T(<repr of the f64>)``, cast
   to the solve's dtype as ``const_like`` casts it).  Identical operations
   on identical registers and literals (a literal's sign of zero
   included) share one register (exact: each is a pure function of its
   inputs), and ``x * 1.0`` is ``x``;
3. **printed** as a CUDA header of the form of ``csrc/sl_model_*.cuh``: a
   struct with the dims, the inequality rows, ``kStream`` and
   ``template <typename T> __host__ __device__`` functions.

``run`` interprets a scalar program with torch ops on the CPU, the way
``interpret=True`` stands in for a Pallas kernel (the tests hold it against
the traced functions, and the printed header against it).

Anything else refuses with ``Refused``, whose message names the op or the
cause; ``ops/sl_forward_kernel.py`` keeps the message as the spec's
``model_reason``.  What stays refused: a branch on a traced value
(``GuardOnDataDependentSymNode``; it fails under ``jax.jit`` too),
data-dependent shapes (``nonzero``, boolean-mask indexing), random ops,
``sort`` and ``topk``, matrix decompositions (``linalg.solve``, ``inv``,
``cholesky``, ``det``), an integer value used other than as an index, a
write into an input, and a value whose dtype is not the input's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import operator
from typing import Callable, Optional

import numpy as np
import torch

from ..models import _const

# aten ops (overload packet names) that lower to scalar operations: the
# method of _Lowering that lowers each, and its flags: "r" it only renames
# registers or makes literals (a closed-over constant of another float
# dtype may pass through it: check_dtype), "i" it takes integer operands as
# indices or passes an index through unchanged, "p" an in-place op that
# changes only a tensor's shape (the graph keeps using the operand, so it
# is rebound to the result)
def _ops(family, flags, names):
    return {name: (family, flags) for name in names.split()}


_LOWERINGS = {
    **_ops("layout", "ri", "select slice view _unsafe_view unsqueeze squeeze stack cat "
                           "lift_fresh_copy clone alias detach _to_copy expand flip unbind "
                           "split split_with_sizes index index_select gather index_put"),
    **_ops("layout", "r", "permute t transpose repeat diagonal select_scatter slice_scatter "
                          "copy"),
    **_ops("layout", "rp", "squeeze_ unsqueeze_"),
    **_ops("layout", "i", "getitem"),
    **_ops("constants", "r", "zeros zeros_like ones ones_like full full_like new_zeros "
                             "new_ones new_full fill eye diag_embed"),
    **_ops("constants", "ri", "arange"),
    **_ops("constants", "", "scalar_tensor"),
    **_ops("math", "", "add sub mul div rsub neg abs sign sigmoid sin cos tan exp log sqrt "
                       "tanh atan asin acos sinh cosh asinh acosh atanh log1p expm1 erf "
                       "rsqrt reciprocal relu softplus atan2 hypot pow minimum maximum "
                       "clamp clamp_min clamp_max gt ge lt le eq ne bitwise_and bitwise_or "
                       "bitwise_not logical_and logical_or logical_not where dot mv mm bmm "
                       "addmm linalg_cross"),
    **_ops("reduction", "", "sum mean prod amax amin max min linalg_vector_norm"),
}
WHITELIST = tuple(_LOWERINGS)

# why an op that users meet stays refused
_NEVER = {
    "nonzero": "a data-dependent shape", "masked_select": "a data-dependent shape",
    "sort": "sorting", "topk": "sorting", "argsort": "sorting",
    "linalg_solve": "a matrix decomposition", "_linalg_solve_ex": "a matrix decomposition",
    "linalg_inv_ex": "a matrix decomposition", "linalg_cholesky_ex": "a matrix decomposition",
    "linalg_lu_factor_ex": "a matrix decomposition", "_linalg_det": "a matrix decomposition",
    "_linalg_slogdet": "a matrix decomposition", "linalg_qr": "a matrix decomposition",
    "_linalg_eigh": "a matrix decomposition", "_linalg_svd": "a matrix decomposition",
    "rand": "a random op", "randn": "a random op", "rand_like": "a random op",
    "randn_like": "a random op", "bernoulli": "a random op", "normal": "a random op",
    "uniform": "a random op", "randint": "a random op", "multinomial": "a random op",
}

# Operations per scalar op for a bound (chip_smoke.py's rule: each add,
# multiply or divide 1, each sin, cos or tan 20; the other transcendental
# functions, their inverses, the hyperbolic ones, atan2, hypot, erf,
# sigmoid and pow as sin; a comparison, select, sign or min/max 1; a
# condition's cast to 0 or 1 and renaming 0)
_TRANSCENDENTAL = ("sin", "cos", "tan", "exp", "log", "tanh", "atan", "asin", "acos", "sinh",
                   "cosh", "asinh", "acosh", "atanh", "log1p", "expm1", "erf", "sigmoid",
                   "atan2", "hypot", "pow")

# scalar ops of one operand printed as the C math call of the same name
_MATH = ("sin", "cos", "tan", "exp", "log", "sqrt", "tanh", "atan", "asin", "acos", "sinh",
         "cosh", "asinh", "acosh", "atanh", "log1p", "expm1", "erf")
_UNARY = ("neg", "abs", "sign", "sigmoid") + _MATH
# scalar ops of two operands printed as the C math call
_BINARY_MATH = ("atan2", "hypot", "pow")
_COMPARE = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==",
            "ne": "!="}
_ARITH = {"add": "+", "sub": "-", "mul": "*", "div": "/"}
# conditions: (aten op, scalar op, C operator)
_LOGIC = {"bitwise_and": "and", "logical_and": "and", "bitwise_or": "or",
          "logical_or": "or", "bitwise_not": "not", "logical_not": "not"}
_C_LOGIC = {"and": "&&", "or": "||"}

class Refused(ValueError):
    """A stage function that cannot become a device function; the message
    names the op or the data-dependent branch."""


class _DataIndex:
    """The indices output of ``max.dim``/``min.dim``: data-dependent, so
    any use of it refuses."""


def _is_lit(a) -> bool:
    return isinstance(a, float)


def _is_index(a) -> bool:
    """A constant integer tensor: an int numpy array (every other value is
    an object array of registers and literals)."""
    return isinstance(a, np.ndarray) and a.dtype.kind in "iu"


@dataclasses.dataclass(frozen=True)
class Program:
    """A straight-line scalar program.  Registers 0..n_in-1 are the inputs
    x, u, w in that order; op i writes register n_in + i.  An op is
    ``(name, args)``; an arg is a register (int) or a literal (float, cast
    to T).  ``kinds[i]`` is "f" (T) or "b" (bool); ``outs`` are registers
    or literals."""

    n_x: int
    n_u: int
    n_w: int
    ops: tuple
    kinds: tuple
    outs: tuple

    @property
    def n_in(self) -> int:
        return self.n_x + self.n_u + self.n_w

    def op_count(self) -> int:
        """Operations of one evaluation under chip_smoke.py's rule; an op on
        literals only is left out (the compiler folds it)."""
        return sum(20 if name in _TRANSCENDENTAL else int(name != "tofloat")
                   for name, args in self.ops if not all(_is_lit(a) for a in args))


def _lit_key(a):
    """A hashable key of an arg: a literal with its sign of zero (0.0 and
    -0.0 are equal in Python but not under atan2 or division)."""
    return (True, a, math.copysign(1.0, a)) if _is_lit(a) else (False, a)


class _Builder:
    """Emits scalar ops with value numbering (one register per distinct
    (op, args))."""

    def __init__(self, n_in: int):
        self.n_in = n_in
        self.ops, self.kinds = [], []
        self._seen = {}

    def kind(self, a) -> str:
        if _is_lit(a) or a < self.n_in:
            return "f"
        return self.kinds[a - self.n_in]

    def emit(self, name, *args, kind="f"):
        if name == "mul":
            # x * 1.0 is x exactly (NaN, infinities and signed zeros too)
            if _is_lit(args[1]) and args[1] == 1.0 and self.kind(args[0]) == "f":
                return args[0]
            if _is_lit(args[0]) and args[0] == 1.0 and self.kind(args[1]) == "f":
                return args[1]
        key = (name, tuple(_lit_key(a) for a in args))
        reg = self._seen.get(key)
        if reg is None:
            reg = self.n_in + len(self.ops)
            self.ops.append((name, tuple(args)))
            self.kinds.append(kind)
            self._seen[key] = reg
        return reg

    def as_float(self, a):
        return self.emit("tofloat", a) if self.kind(a) == "b" else a


def _elementwise(fn, *arrays):
    """``fn`` over scalar refs of broadcast object arrays."""
    arrays = np.broadcast_arrays(*[np.asarray(a, dtype=object) for a in arrays])
    out = np.empty(arrays[0].shape, dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = fn(*(a[idx] for a in arrays))
    return out


def _obj(a):
    """A scalar literal or ref as a 0-d object array; arrays pass."""
    if isinstance(a, np.ndarray):
        return a
    out = np.empty((), dtype=object)
    out[()] = a
    return out


def _lit(v) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise Refused(f"non-numeric scalar argument {v!r}")
    return float(v)


def _operand(a):
    """A tensor operand (an object array) or a Python scalar as a 0-d
    literal array."""
    return _obj(a if isinstance(a, np.ndarray) else _lit(a))


def _literals(shape, value=0.0):
    return np.full(tuple(shape), float(value), dtype=object)


def _fold(b, op, terms):
    """``op`` over the terms, left to right (``sum``'s order)."""
    acc = None
    for t in terms:
        acc = t if acc is None else b.emit(op, acc, t)
    return acc


def _sequential_sum(b, terms):
    acc = _fold(b, "add", terms)
    return 0.0 if acc is None else acc


def _products(b, a, v):
    """sum_l a[l] * v[l], left to right."""
    return _sequential_sum(b, [b.emit("mul", b.as_float(p), b.as_float(q))
                               for p, q in zip(a, v)])


def _matmul(b, A, B):
    """A [..., n, k] @ B [..., k, m] with broadcast batch axes, each entry
    unrolled left to right."""
    lead = np.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    A = np.broadcast_to(A, lead + A.shape[-2:])
    B = np.broadcast_to(B, lead + B.shape[-2:])
    out = np.empty(lead + (A.shape[-2], B.shape[-1]), dtype=object)
    for idx in np.ndindex(out.shape):
        *bat, i, j = idx
        out[idx] = _products(b, A[tuple(bat) + (i,)], B[tuple(bat) + (slice(None), j)])
    return out


def _pow(b, a, e):
    """torch's pow(x, e) for a Python exponent: products or a square root
    for the exponents aten's pow_tensor_scalar_optimized forms that way,
    ``pow(x, e)`` for any other."""
    a = b.as_float(a)
    if e == 1.0:
        return a
    if e == 2.0:
        return b.emit("mul", a, a)
    if e == 3.0:
        return b.emit("mul", b.emit("mul", a, a), a)
    if e == 0.5:
        return b.emit("sqrt", a)
    if e == -1.0:
        return b.emit("div", 1.0, a)
    if e == -2.0:
        return b.emit("div", 1.0, b.emit("mul", a, a))
    if e == -0.5:
        return b.emit("div", 1.0, b.emit("sqrt", a))
    if float(e).is_integer() and 4.0 <= e <= 16.0:
        acc = a
        for _ in range(int(e) - 1):
            acc = b.emit("mul", acc, a)
        return acc
    return b.emit("pow", a, float(e))


def _dims(a, dims):
    """Sorted non-negative reduction dims (None or [] = all)."""
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        return list(range(a.ndim))
    return sorted(d % max(a.ndim, 1) for d in ([dims] if isinstance(dims, int) else dims))


def _reduce(a, dims, keep, fold):
    """``fold(list of refs)`` over ``dims`` of ``a`` (in index order), the
    other axes kept; ``keep`` keeps the reduced axes at size 1."""
    a = np.asarray(a, dtype=object)
    dims = [d for d in _dims(a, dims) if d < a.ndim]
    rest = [d for d in range(a.ndim) if d not in dims]
    flat = np.transpose(a, rest + dims).reshape([a.shape[d] for d in rest] + [-1])
    out = np.empty(flat.shape[:-1], dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = fold(list(flat[idx]))
    if keep:
        for d in dims:
            out = np.expand_dims(out, d)
    return out


def _assign(out, index, src):
    """``out[index] = src`` with ``src`` broadcast to the target (an
    element is stored as its ref, never as a 0-d array)."""
    vals = np.broadcast_to(np.asarray(src, dtype=object), np.shape(out[index]))
    out[index] = vals[()] if vals.ndim == 0 else vals


def _index_tuple(indices, what):
    """numpy's index of aten's ``indices`` list: constant integer arrays
    (None keeps an axis)."""
    out = []
    for i in indices:
        if i is None:
            out.append(slice(None))
        elif _is_index(i):
            out.append(i)
        elif isinstance(i, np.ndarray) and i.dtype == bool:
            raise Refused(f"{what} with a constant boolean mask (boolean-mask indexing)")
        else:
            raise Refused(f"{what} with indices computed from the inputs (boolean-mask "
                          "indexing or a data-dependent index: a data-dependent shape)")
    return tuple(out)


class _Lowering:
    """Walks one traced aten graph and builds its scalar program."""

    def __init__(self, gm, n_x, n_u, n_w, terminal):
        self.gm = gm
        self.n = (n_x, 0 if terminal else n_u, n_w)
        self.b = _Builder(sum(self.n))
        regs = lambda lo, n: np.array(list(range(lo, lo + n)), dtype=object)
        # a terminal object: the kernels and the plain version pass u = 0
        u = np.array([0.0] * n_u, dtype=object) if terminal else regs(n_x, n_u)
        self.inputs = [regs(0, n_x), u, regs(n_x + self.n[1], n_w)]

    def arg(self, env, a):
        import torch.fx as fx

        if isinstance(a, fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return [self.arg(env, v) for v in a]
        return a

    def run(self):
        env = {}
        inputs = iter(self.inputs)
        out = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(inputs)
            elif node.op == "get_attr":
                env[node] = self.constant(getattr(self.gm, node.target), node.target)
            elif node.op == "call_function":
                args = [self.arg(env, a) for a in node.args]
                kwargs = {k: self.arg(env, v) for k, v in node.kwargs.items()}
                res = self.call(node.target, args, kwargs)
                env[node] = res if isinstance(res, (list, _DataIndex)) else _obj(res)
                self.check_dtype(node, env[node])
                if "p" in _LOWERINGS.get(_name(node.target), ("", ""))[1]:
                    env[node.args[0]] = env[node]
            elif node.op == "output":
                out = self.arg(env, node.args[0])
            else:
                raise Refused(f"graph node {node.op} {node.target}")
        if isinstance(out, (list, tuple)):
            if len(out) != 1:
                raise Refused("a stage function returns one tensor")
            out = out[0]
        if _is_index(out) or isinstance(out, _DataIndex):
            raise Refused("a stage function returns an integer value")
        outs = tuple(np.asarray(out, dtype=object).reshape(-1).tolist())
        for o in outs:
            if self.b.kind(o) != "f":
                raise Refused("a stage function returns a boolean value")
        return self.program(outs)

    def program(self, outs):
        """The program with the ops the outputs do not reach removed."""
        b, n_in = self.b, self.b.n_in
        live = set(o for o in outs if not _is_lit(o) and o >= n_in)
        for i in range(len(b.ops) - 1, -1, -1):
            if n_in + i in live:
                live.update(a for a in b.ops[i][1] if not _is_lit(a) and a >= n_in)
        keep = [i for i in range(len(b.ops)) if n_in + i in live]
        new = {n_in + i: n_in + j for j, i in enumerate(keep)}
        ren = lambda a: a if _is_lit(a) or a < n_in else new[a]
        ops = tuple((b.ops[i][0], tuple(ren(a) for a in b.ops[i][1])) for i in keep)
        return Program(self.n[0], self.n[1], self.n[2], ops,
                       tuple(b.kinds[i] for i in keep), tuple(ren(o) for o in outs))

    @staticmethod
    def constant(t, name):
        """A closed-over tensor: float literals, or a constant integer
        array (taken only as an index)."""
        if not isinstance(t, torch.Tensor):
            raise Refused(f"constant {name} is not a tensor")
        if t.dtype == torch.bool:
            raise Refused(f"constant {name} is a boolean tensor (boolean-mask indexing or a "
                          "constant condition)")
        if not t.is_floating_point():
            if t.is_complex():
                raise Refused(f"constant {name} is complex")
            return t.detach().to("cpu", torch.int64).numpy().copy()
        vals = t.detach().to("cpu", torch.float64).numpy()
        return np.vectorize(float, otypes=[object])(vals) if vals.ndim else _obj(float(vals))

    @staticmethod
    def check_dtype(node, out):
        """Every value is the input's f64 (or a condition), but for a
        constant integer index, and for a renaming of a closed-over constant
        of another float dtype (its values are exact in f64, and an op that
        meets the input promotes them as T does)."""
        val = node.meta.get("val")
        if (not isinstance(val, torch.Tensor) or isinstance(out, (list, _DataIndex))
                or val.dtype in (torch.float64, torch.bool)):
            return
        if _is_index(out) and not val.is_floating_point():
            return
        if ("r" in _LOWERINGS.get(_name(node.target), ("", ""))[1] and val.is_floating_point()
                and all(_is_lit(a) for a in out.reshape(-1))):
            return
        raise Refused(f"{node.target} gives dtype {val.dtype}, not the input's "
                      "torch.float64")

    def call(self, target, args, kw):
        name = _name(target)
        if name not in _LOWERINGS:
            why = f" ({_NEVER[name]})" if name in _NEVER else ""
            raise Refused(f"{target}{why} is not among the ops that lower to device "
                          "functions (ops/device_functions.py: WHITELIST)")
        family, flags = _LOWERINGS[name]
        flat = _flatten(args) + _flatten(list(kw.values()))
        if name != "getitem" and any(isinstance(a, _DataIndex) for a in flat):
            raise Refused(f"{target} on the indices of max/min (a data-dependent index)")
        if "i" not in flags and any(_is_index(a) for a in flat):
            raise Refused(f"{target} on an integer tensor: an integer value lowers only as "
                          "an index")
        out = getattr(self, family)(name, target, args, kw)
        if out is not NotImplemented:
            return out
        raise Refused(f"{target}: no lowering")  # a whitelisted op's other overload

    # -- layout: renames ----------------------------------------------------

    def layout(self, name, target, args, kw):
        b = self.b
        a = args[0] if args else None
        if name in ("lift_fresh_copy", "clone", "alias", "detach"):
            return a
        if name == "getitem":
            return a[args[1]]
        if name == "_to_copy":
            want = kw.get("dtype")
            if _is_index(a):
                if want is None or not want.is_floating_point:
                    return a
                return np.vectorize(float, otypes=[object])(a) if a.ndim else _obj(float(a))
            # a move or a cast to the input's dtype (a cast to another dtype
            # is refused by check_dtype); a condition becomes 0 or 1
            return _elementwise(b.as_float, a)
        if name == "select":
            return a[(slice(None),) * (args[1] % a.ndim) + (args[2],)]
        if name == "slice":
            dim = args[1] if len(args) > 1 else 0
            start = args[2] if len(args) > 2 else None
            end = args[3] if len(args) > 3 else None
            step = args[4] if len(args) > 4 else 1
            sl = [slice(None)] * a.ndim
            sl[dim] = slice(start, end, step)
            return a[tuple(sl)]
        if name in ("view", "_unsafe_view"):
            return np.reshape(a, args[1])
        if name in ("unsqueeze", "unsqueeze_"):
            return np.expand_dims(a, args[1] % (a.ndim + 1))
        if name in ("squeeze", "squeeze_"):
            dims = args[1] if len(args) > 1 else None
            dims = [d for d in _dims(a, dims) if a.ndim and a.shape[d] == 1]
            return np.squeeze(a, axis=tuple(dims)) if dims else a
        if name == "permute":
            return np.transpose(a, [d % a.ndim for d in args[1]])
        if name == "t":
            return a.T if a.ndim == 2 else a
        if name == "transpose":
            return np.swapaxes(a, args[1], args[2])
        if name == "expand":
            sizes = list(args[1])
            shape = [a.shape[i - (len(sizes) - a.ndim)] if s == -1 else s
                     for i, s in enumerate(sizes)]
            return np.broadcast_to(a, shape)
        if name == "repeat":
            return np.tile(a, args[1])
        if name == "flip":
            return np.flip(a, axis=tuple(args[1]))
        if name == "diagonal":
            offset = args[1] if len(args) > 1 else kw.get("offset", 0)
            d1 = args[2] if len(args) > 2 else kw.get("dim1", 0)
            d2 = args[3] if len(args) > 3 else kw.get("dim2", 1)
            return np.diagonal(a, offset, d1, d2)
        if name in ("stack", "cat"):
            dim = args[1] if len(args) > 1 else kw.get("dim", 0)
            parts = [np.asarray(p) for p in a]
            if len({_is_index(p) for p in parts}) > 1:
                raise Refused(f"{target} of an integer tensor with values: an integer value "
                              "lowers only as an index")
            if name == "cat":
                parts = [p for p in parts if p.shape != (0,)] or parts[:1]
            return (np.stack if name == "stack" else np.concatenate)(parts, axis=dim)
        if name == "unbind":
            dim = args[1] if len(args) > 1 else kw.get("dim", 0)
            return list(np.moveaxis(a, dim, 0))
        if name in ("split", "split_with_sizes"):
            sizes, dim = args[1], args[2] if len(args) > 2 else kw.get("dim", 0)
            n = a.shape[dim]
            if isinstance(sizes, int):
                sizes = [min(sizes, n - lo) for lo in range(0, n, sizes)]
            cuts = np.cumsum(sizes)[:-1]
            return list(np.split(a, cuts, axis=dim))
        if name == "index":
            return a[_index_tuple(args[1], target)]
        if name == "index_select":
            if not _is_index(args[2]):
                raise Refused(f"{target} with an index computed from the inputs")
            return np.take(a, args[2], axis=args[1])
        if name == "gather":
            dim, idx = args[1], args[2]
            if not _is_index(idx):
                raise Refused(f"{target} with an index computed from the inputs")
            out = np.empty(idx.shape, dtype=object)
            for pos in np.ndindex(idx.shape):
                src = list(pos)
                src[dim] = idx[pos]
                out[pos] = a[tuple(src)]
            return out
        if name == "copy":
            # out-of-place copy(dst, src): src's values in dst's shape
            return np.array(_elementwise(b.as_float, np.broadcast_to(args[1], a.shape)))
        if name == "index_put":
            accumulate = args[3] if len(args) > 3 else kw.get("accumulate", False)
            if accumulate:
                raise Refused(f"{target} with accumulate=True")
            out = np.array(a, dtype=object)
            _assign(out, _index_tuple(args[1], target), _elementwise(b.as_float, args[2]))
            return out
        if name in ("select_scatter", "slice_scatter"):
            src, dim = args[1], args[2] if len(args) > 2 else kw.get("dim", 0)
            out = np.array(a, dtype=object)
            sl = [slice(None)] * a.ndim
            if name == "select_scatter":
                sl[dim % a.ndim] = args[3]
            else:
                start = args[3] if len(args) > 3 else kw.get("start")
                end = args[4] if len(args) > 4 else kw.get("end")
                step = args[5] if len(args) > 5 else kw.get("step", 1)
                sl[dim % a.ndim] = slice(start, end, step)
            _assign(out, tuple(sl), _elementwise(b.as_float, src))
            return out
        return NotImplemented

    # -- literals -------------------------------------------------------------

    def constants(self, name, target, args, kw):
        a = args[0] if args else None
        if name == "scalar_tensor":
            return _obj(_lit(a))
        if name in ("zeros", "ones"):
            return _literals(a, 0.0 if name == "zeros" else 1.0)
        if name == "full":
            return _literals(args[0], _lit(args[1]))
        if name in ("zeros_like", "ones_like", "new_zeros", "new_ones"):
            shape = np.shape(a) if name.endswith("like") else args[1]
            return _literals(shape, 0.0 if "zeros" in name else 1.0)
        if name == "full_like":
            return _literals(np.shape(a), _lit(args[1]))
        if name == "new_full":
            return _literals(args[1], _lit(args[2]))
        if name == "fill":
            v = args[1]
            if isinstance(v, np.ndarray):
                return np.array(np.broadcast_to(_elementwise(self.b.as_float, v), a.shape))
            return _literals(np.shape(a), _lit(v))
        if name == "eye":
            n = args[0]
            m = args[1] if len(args) > 1 else n
            return np.vectorize(float, otypes=[object])(np.eye(n, m))
        if name == "arange":
            nums = [v for v in args]
            vals = np.arange(*nums)
            dtype = kw.get("dtype")
            if dtype is not None and dtype.is_floating_point:
                return np.vectorize(float, otypes=[object])(vals.astype(np.float64))
            if vals.dtype.kind == "f":
                raise Refused(f"{target} of floats with no dtype")
            return vals.astype(np.int64)
        if name == "diag_embed":
            offset = args[1] if len(args) > 1 else kw.get("offset", 0)
            d1 = args[2] if len(args) > 2 else kw.get("dim1", -2)
            d2 = args[3] if len(args) > 3 else kw.get("dim2", -1)
            if (d1 % (a.ndim + 1), d2 % (a.ndim + 1)) != (a.ndim - 1, a.ndim):
                raise Refused(f"{target} into other dims than the last two")
            n = a.shape[-1] + abs(offset)
            out = _literals(a.shape[:-1] + (n, n))
            for i in range(a.shape[-1]):
                r, c = (i, i + offset) if offset >= 0 else (i - offset, i)
                _assign(out, (Ellipsis, r, c), a[..., i])
            return out
        return NotImplemented

    # -- elementwise math and products ----------------------------------------

    def math(self, name, target, args, kw):
        b = self.b
        a = args[0] if args else None
        if name in _ARITH or name == "rsub":
            alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
            if alpha != 1 or kw.get("rounding_mode") is not None:
                raise Refused(f"{target} with alpha or rounding_mode")
            x, y = (_operand(v) for v in args[:2])
            if name == "rsub":
                name, x, y = "sub", y, x
            return _elementwise(lambda p, q: b.emit(name, b.as_float(p), b.as_float(q)), x, y)
        if name in _UNARY:
            return _elementwise(lambda p: b.emit(name, b.as_float(p)), a)
        if name == "rsqrt":
            return _elementwise(lambda p: b.emit("div", 1.0, b.emit("sqrt", b.as_float(p))), a)
        if name == "reciprocal":
            return _elementwise(lambda p: b.emit("div", 1.0, b.as_float(p)), a)
        if name == "relu":
            return _elementwise(lambda p: b.emit("max", b.as_float(p), 0.0), a)
        if name == "softplus":
            beta = _lit(args[1] if len(args) > 1 else kw.get("beta", 1.0))
            threshold = _lit(args[2] if len(args) > 2 else kw.get("threshold", 20.0))

            def softplus(p):
                p = b.as_float(p)
                xb = b.emit("mul", p, beta)
                soft = b.emit("log1p", b.emit("exp", xb))
                if beta != 1.0:
                    soft = b.emit("div", soft, beta)
                return b.emit("where", b.emit("gt", xb, threshold, kind="b"), p, soft)

            return _elementwise(softplus, a)
        if name in ("atan2", "hypot"):
            return _elementwise(lambda p, q: b.emit(name, b.as_float(p), b.as_float(q)),
                                *(_operand(v) for v in args[:2]))
        if name == "pow":
            base, e = args[:2]
            if isinstance(base, np.ndarray) and not isinstance(e, np.ndarray):
                return _elementwise(lambda p: _pow(b, p, _lit(e)), base)
            return _elementwise(lambda p, q: b.emit("pow", b.as_float(p), b.as_float(q)),
                                _operand(base), _operand(e))
        if name in ("minimum", "maximum"):
            op = "min" if name == "minimum" else "max"
            return _elementwise(lambda p, q: b.emit(op, b.as_float(p), b.as_float(q)),
                                *(_obj(v) for v in args[:2]))
        if name in ("clamp", "clamp_min", "clamp_max"):
            lo = args[1] if len(args) > 1 else kw.get("min")
            hi = args[2] if len(args) > 2 else kw.get("max")
            if name == "clamp_max":
                lo, hi = None, lo
            out = a
            if lo is not None:
                out = _elementwise(lambda p, q: b.emit("max", b.as_float(p), q), out,
                                   _operand(lo))
            if hi is not None:
                out = _elementwise(lambda p, q: b.emit("min", b.as_float(p), q), out,
                                   _operand(hi))
            return out
        if name in _COMPARE:
            return _elementwise(lambda p, q: b.emit(name, b.as_float(p), b.as_float(q),
                                                    kind="b"), a, _operand(args[1]))
        if name in _LOGIC:
            op = _LOGIC[name]

            def cond(*ps):
                if any(b.kind(p) != "b" for p in ps):
                    raise Refused(f"{target} on a value that is not a condition")
                return b.emit(op, *ps, kind="b")

            return _elementwise(cond, *args[: 1 if op == "not" else 2])
        if name == "where":
            c, x, y = (_operand(v) for v in args[:3])

            def sel(p, q, r):
                if b.kind(p) != "b":
                    p = b.emit("ne", p, 0.0, kind="b")
                return b.emit("where", p, b.as_float(q), b.as_float(r))

            return _elementwise(sel, c, x, y)
        if name == "dot":
            return _obj(_products(b, args[0], args[1]))
        if name == "mv":
            A, x = args
            out = np.empty(A.shape[0], dtype=object)
            for i in range(A.shape[0]):
                out[i] = _products(b, A[i], x)
            return out
        if name in ("mm", "bmm"):
            return _matmul(b, args[0], args[1])
        if name == "addmm":
            beta = _lit(kw.get("beta", 1))
            alpha = _lit(kw.get("alpha", 1))
            if (beta, alpha) != (1.0, 1.0):
                raise Refused(f"{target} with beta or alpha")
            prod = _matmul(b, args[1], args[2])
            return _elementwise(lambda p, q: b.emit("add", b.as_float(q), b.as_float(p)),
                                a, prod)
        if name == "linalg_cross":
            dim = args[2] if len(args) > 2 else kw.get("dim", -1)
            x, y = np.broadcast_arrays(np.moveaxis(a, dim, -1), np.moveaxis(args[1], dim, -1))
            if x.shape[-1] != 3:
                raise Refused(f"{target} of vectors of {x.shape[-1]} entries")

            def term(i, j):
                return _elementwise(lambda p, q, r, s: b.emit(
                    "sub", b.emit("mul", b.as_float(p), b.as_float(q)),
                    b.emit("mul", b.as_float(r), b.as_float(s))),
                    x[..., i], y[..., j], x[..., j], y[..., i])

            return np.moveaxis(np.stack([term(1, 2), term(2, 0), term(0, 1)], axis=-1), -1, dim)
        return NotImplemented

    # -- reductions -------------------------------------------------------------

    def reduction(self, name, target, args, kw):
        b = self.b
        a = np.asarray(args[0], dtype=object) if args else None
        dims = args[1] if len(args) > 1 else kw.get("dim")
        keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
        flt = lambda ts: [b.as_float(t) for t in ts]
        if name in ("sum", "mean", "prod"):
            if kw.get("dtype") is not None or (len(args) > 3 and args[3] is not None):
                raise Refused(f"{target} with a dtype")
            if name == "prod":
                # prod(x) and prod(x, dim, keepdim): one dim or all
                return _reduce(a, dims if len(args) > 1 else None, keep,
                               lambda ts: _fold(b, "mul", flt(ts)) if ts else 1.0)
            out = _reduce(a, dims, keep, lambda ts: _sequential_sum(b, flt(ts)))
            if name == "mean":
                n = a.size // max(out.size, 1)
                out = _elementwise(lambda p: b.emit("div", p, float(n)), out)
            return out
        if name in ("amax", "amin", "max", "min"):
            op = name[-3:]
            if len(args) == 2 and isinstance(args[1], np.ndarray):
                # torch.max(a, b): elementwise
                return _elementwise(lambda p, q: b.emit(op, b.as_float(p), b.as_float(q)),
                                    a, args[1])
            if name in ("max", "min") and len(args) == 1:
                dims = None
            out = _reduce(a, dims, keep, lambda ts: _fold(b, op, flt(ts)))
            if name in ("max", "min") and len(args) > 1:
                return [out, _DataIndex()]     # (values, indices)
            return out
        if name == "linalg_vector_norm":
            ord_ = _lit(args[1] if len(args) > 1 else kw.get("ord", 2))
            dims = args[2] if len(args) > 2 else kw.get("dim")
            keep = args[3] if len(args) > 3 else kw.get("keepdim", False)
            if kw.get("dtype") is not None:
                raise Refused(f"{target} with a dtype")
            absv = lambda ts: [b.emit("abs", t) for t in flt(ts)]
            if ord_ == math.inf or ord_ == -math.inf:
                op = "max" if ord_ > 0 else "min"
                return _reduce(a, dims, keep, lambda ts: _fold(b, op, absv(ts)))
            if ord_ == 1.0:
                return _reduce(a, dims, keep, lambda ts: _sequential_sum(b, absv(ts)))
            if ord_ == 2.0:
                return _reduce(a, dims, keep, lambda ts: b.emit("sqrt", _sequential_sum(
                    b, [b.emit("mul", t, t) for t in flt(ts)])))
            if ord_ > 0:
                return _reduce(a, dims, keep, lambda ts: b.emit("pow", _sequential_sum(
                    b, [b.emit("pow", t, ord_) for t in absv(ts)]), 1.0 / ord_))
            raise Refused(f"{target} at ord {ord_!r} (ord > 0 and +-inf lower)")
        return NotImplemented


def _name(target) -> str:
    """The aten overload packet's name (``operator.getitem``: "getitem")."""
    if target is operator.getitem:
        return "getitem"
    return target.overloadpacket.__name__ if hasattr(target, "overloadpacket") else str(target)


def _flatten(vals) -> list:
    out = []
    for v in vals:
        if isinstance(v, (list, tuple)):
            out += _flatten(v)
        else:
            out.append(v)
    return out


def trace(fn: Callable, n_x: int, n_u: int, n_w: int, *, terminal: bool = False,
          device="cpu") -> Program:
    """The scalar program of ``fn(x [n_x], u [n_u], w [n_w])``, traced with
    fake f64 tensors on ``device`` (the solve's: a closed-over constant
    lives there) through ``torch.func.functionalize`` (a write into a
    tensor becomes an out-of-place op).  ``terminal``: the kernels call it
    with u = 0 (a terminal cost or constraint), so u becomes literal zeros.
    Raises ``Refused``."""
    from torch._subclasses.fake_tensor import DataDependentOutputException, \
        DynamicOutputShapeException
    from torch.func import functionalize
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode

    z = lambda n: torch.zeros(n, dtype=torch.float64, device=device)
    saved = dict(_const._CACHE)
    try:
        gm = make_fx(functionalize(fn), tracing_mode="fake", _allow_non_fake_inputs=True)(
            z(n_x), z(n_u), z(n_w))
    except GuardOnDataDependentSymNode as e:
        raise Refused("a data-dependent branch (Python control flow on a traced "
                      f"value): {str(e).splitlines()[0]}") from None
    except (DynamicOutputShapeException, DataDependentOutputException) as e:
        raise Refused(f"a data-dependent shape: {str(e).splitlines()[0]}") from None
    except Exception as e:  # noqa: BLE001 -- any trace failure is a refusal with its reason
        raise Refused(f"tracing failed: {type(e).__name__}: {str(e).splitlines()[0]}") from None
    finally:
        _const._CACHE.clear()
        _const._CACHE.update(saved)
    return _Lowering(gm, n_x, n_u, n_w, terminal).run()


# ---------------------------------------------------------------------------
# Interpreter (the CPU's stand-in for the printed device functions)
# ---------------------------------------------------------------------------


def run(prog: Program, x, u, w) -> torch.Tensor:
    """Interprets ``prog`` with torch ops on inputs with any trailing batch
    shape: x [n_x, ...], u [n_u, ...], w [n_w, ...] (a terminal program's u
    is ignored) -> [len(outs), ...].  A literal becomes a 0-d tensor of the
    inputs' dtype, the value torch casts a Python float to in an op."""
    like = x[0]
    lit = lambda a: torch.tensor(a, dtype=like.dtype, device=like.device)
    regs = list(x) + list(u[: prog.n_u]) + list(w[: prog.n_w])
    fns = {"add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
           "min": torch.minimum, "max": torch.maximum, "and": torch.logical_and,
           "sign": torch.sign, "sigmoid": torch.sigmoid, "atan2": torch.atan2,
           "hypot": torch.hypot, "pow": torch.pow,
           "or": torch.logical_or, "not": torch.logical_not,
           "where": torch.where, "tofloat": lambda a: a.to(like.dtype)}
    for name, args in prog.ops:
        v = [lit(a) if _is_lit(a) else regs[a] for a in args]
        fn = fns.get(name) or getattr(torch, name)
        regs.append(fn(*v))
    outs = [torch.broadcast_to(lit(o) if _is_lit(o) else regs[o], like.shape)
            for o in prog.outs]
    return torch.stack(outs) if outs else like.new_zeros((0,) + tuple(like.shape))


# ---------------------------------------------------------------------------
# CUDA printer
# ---------------------------------------------------------------------------


def _c_lit(v: float) -> str:
    if math.isnan(v):
        return "T(NAN)"
    if math.isinf(v):
        return "T(HUGE_VAL)" if v > 0 else "-T(HUGE_VAL)"
    return f"T({v!r})"


def _c_ref(prog: Program, a) -> str:
    if _is_lit(a):
        return _c_lit(a)
    if a < prog.n_x:
        return f"x[{a}]"
    if a < prog.n_x + prog.n_u:
        return f"u[{a - prog.n_x}]"
    if a < prog.n_in:
        return f"w[{a - prog.n_x - prog.n_u}]"
    return f"r{a}"


def _c_body(prog: Program, out: Optional[str]) -> list:
    """The statements of one program; ``out`` None returns its single
    output, else writes out[i]."""
    lines = []
    for i, (name, args) in enumerate(prog.ops):
        reg = prog.n_in + i
        a = [_c_ref(prog, v) for v in args]
        if name in _ARITH:
            e = f"{a[0]} {_ARITH[name]} {a[1]}"
        elif name == "neg":
            e = f"-{a[0]}"
        elif name == "abs":
            e = f"fabs({a[0]})"
        elif name in _MATH or name in _BINARY_MATH:
            e = f"{name}({', '.join(a)})"
        elif name in ("sign", "sigmoid"):
            e = f"g{name}({a[0]})"
        elif name in ("min", "max"):
            e = f"g{name}({a[0]}, {a[1]})"
        elif name in _COMPARE:
            e = f"{a[0]} {_COMPARE[name]} {a[1]}"
        elif name in _C_LOGIC:
            e = f"{a[0]} {_C_LOGIC[name]} {a[1]}"
        elif name == "not":
            e = f"!{a[0]}"
        elif name == "where":
            e = f"{a[0]} ? {a[1]} : {a[2]}"
        elif name == "tofloat":
            e = f"{a[0]} ? T(1) : T(0)"
        else:
            raise AssertionError(name)
        ty = "bool" if prog.kinds[i] == "b" else "T"
        lines.append(f"    const {ty} r{reg} = {e};")
    if out is None:
        lines.append(f"    return {_c_ref(prog, prog.outs[0])};")
    else:
        lines += [f"    {out}[{i}] = {_c_ref(prog, o)};" for i, o in enumerate(prog.outs)]
    return lines


# The ring pays where the step is long: the producer warp and the ring's
# waits cost about what they hide on a step of car's length (its hand
# header loads in the step, timed both ways on the H100), and hide a
# memory latency a step on the longer chains.  So a generated model streams
# its step inputs when a step and candidate takes at least STREAM_OPS
# operations (ops_per_step), which gives the hand headers' choices: acrobot
# (279), cartpole (194) and the quadrotor (654) stream; car (126), pendulum
# (73) and particle (23) load in the step.
STREAM_OPS = 160

# the five stage objects, in the kernels' order, and their C signatures
_SLOTS = (
    ("dyn", "void", "const T* x, const T* u, const T* w, const T* /*prm*/, T* xn", "xn"),
    ("stage_cost", "T", "const T* x, const T* u, const T* w, const T* /*prm*/", None),
    ("term_cost", "T", "const T* x, const T* w, const T* /*prm*/", None),
    ("stage_con", "void", "const T* x, const T* u, const T* w, const T* /*prm*/, T* c", "c"),
    ("term_con", "void", "const T* x, const T* w, const T* /*prm*/, T* c", "c"),
)


@dataclasses.dataclass(frozen=True)
class GeneratedModel:
    """The device model of one spec: its five programs (a constraint None
    where the block is empty), dims, inequality rows, the ring choice, and
    the printed header; ``name`` keys its C symbols."""

    programs: tuple
    nx: int
    nu: int
    nw: int
    nc: int
    nc_stage: int
    nc_term: int
    ineq: tuple
    ineq_T: tuple
    stream: bool
    header: str
    name: str

    def translation_unit(self) -> str:
        """The CUDA source of this model's K3/K4 library: the header, the
        rollout body and its f32 and f64 entry points."""
        struct = "Gen_" + self.name[len("gen_"):]
        return (self.header + '\n#include "sl_rollout.cuh"\n\n'
                + f"SL_ENTRIES({self.name}_f32, sl_models::{struct}, float)\n"
                + f"SL_ENTRIES({self.name}_f64, sl_models::{struct}, double)\n")

    def ops_per_step(self) -> int:
        return _ops_per_step(self.programs, self.nx, self.nu, self.nc_stage)


def _ops_per_step(programs, nx, nu, nc_stage) -> int:
    """Operations of one rollout step and candidate under chip_smoke.py's
    rule: the dynamics, the stage cost, the stage constraint, the control
    u = ubar + K (x - xbar) + alpha k (nx + 2 nu nx + 3 nu), the stage AL
    terms (6 a row) and the accumulations into J."""
    dyn, cost, _, con, _ = programs
    n = dyn.op_count() + cost.op_count() + 1 + nx + 2 * nu * nx + 3 * nu
    if nc_stage:
        n += con.op_count() + 6 * nc_stage + 1
    return n


def _mask(rows) -> str:
    return f"{sum(1 << i for i in rows)}ull"


def print_header(programs, nx, nu, nw, nc, nc_stage, nc_term, ineq, ineq_T,
                 stream, struct: str) -> str:
    """The CUDA header of a generated model (``csrc/sl_model_*.cuh``'s
    form)."""
    lines = [
        "// Device functions generated by iterativelqr_tpu_torch/ops/device_functions.py",
        "// from a problem's torch stage functions, for the rollout kernels K3/K4",
        "// (sl_rollout.cuh).  Each function is the traced function's scalar",
        "// program: its operations in the traced order, literals cast to T.",
        "#pragma once",
        "",
        "#include <cmath>",
        "",
        "namespace sl_models {",
        "",
        "#ifndef __CUDACC__",
        "using std::cos; using std::exp; using std::fabs; using std::log;",
        "using std::sin; using std::sqrt; using std::tan; using std::tanh;",
        "using std::acos; using std::acosh; using std::asin; using std::asinh;",
        "using std::atan; using std::atan2; using std::atanh; using std::cosh;",
        "using std::erf; using std::expm1; using std::hypot; using std::log1p;",
        "using std::pow; using std::sinh;",
        "#endif",
        "",
        f"struct {struct} {{",
        f"  static constexpr int NX = {nx}, NU = {nu}, NW = {nw}, NP = 0;",
        f"  static constexpr int NC_STAGE = {nc_stage}, NC_TERM = {nc_term};",
        f"  static constexpr int NC = {nc};",
        f"  static constexpr unsigned long long INEQ_STAGE = {_mask(ineq)}, "
        f"INEQ_TERM = {_mask(ineq_T)};",
        f"  static constexpr bool kStream = {'true' if stream else 'false'};",
        "",
        "  // torch.minimum / torch.maximum: NaN in either operand gives NaN",
        "  template <typename T>",
        "  __host__ __device__ static T gmin(T a, T b) { return (a != a || b != b) ? a + b : (b < a ? b : a); }",
        "  template <typename T>",
        "  __host__ __device__ static T gmax(T a, T b) { return (a != a || b != b) ? a + b : (b > a ? b : a); }",
        "  // torch.sign (0 for NaN, as on the CPU) and torch.sigmoid",
        "  template <typename T>",
        "  __host__ __device__ static T gsign(T a) { return T((T(0) < a) - (a < T(0))); }",
        "  template <typename T>",
        "  __host__ __device__ static T gsigmoid(T a) { return T(1) / (T(1) + exp(-a)); }",
    ]
    for (fname, ret, sig, out), prog in zip(_SLOTS, programs):
        lines += ["", "  template <typename T>",
                  f"  __host__ __device__ static {ret} {fname}({sig}) {{"]
        if prog is not None:
            lines += _c_body(prog, out)
        lines.append("  }")
    lines += ["};", "", "}  // namespace sl_models", ""]
    return "\n".join(lines)


def stage_objects(spec) -> tuple:
    """The five stage objects the kernels call: dynamics, stage cost,
    terminal cost, stage constraint, terminal constraint."""
    return (
        spec.dyn_types[int(spec.dyn_tidx[0])],
        spec.cost_types[int(spec.cost_tidx[0])],
        spec.cost_types[int(spec.cost_tidx[-1])],
        spec.con_types[int(spec.con_tidx[0])],
        spec.con_types[int(spec.con_tidx[-1])],
    )


def _rows(mask_row) -> tuple:
    return tuple(int(i) for i in np.nonzero(mask_row)[0])


def generate(spec, device="cpu") -> GeneratedModel:
    """The generated device model of a stage-uniform spec
    (``ops/sl_forward_kernel.kernel_eligible``) solved on ``device``;
    raises ``Refused``."""
    objs = stage_objects(spec)
    if objs[0].num_state != spec.nx or objs[0].num_next_state != spec.nx:
        raise Refused("the dynamics change the state dimension")
    programs = []
    for i, o in enumerate(objs):
        if o.f is None:
            programs.append(None)
            continue
        if o.num_state != spec.nx:
            raise Refused(f"a stage function takes {o.num_state} of {spec.nx} states")
        terminal = i in (2, 4)
        try:
            p = trace(o._fn, o.num_state, o.num_action, o.num_parameter,
                      terminal=terminal, device=device)
        except Refused as e:
            raise Refused(f"{_SLOTS[i][0]}: {e}") from None
        want = spec.nx if i == 0 else (1 if i in (1, 2) else o.num_constraint)
        if len(p.outs) != want:
            raise Refused(f"{_SLOTS[i][0]} gives {len(p.outs)} values, not {want}")
        programs.append(p)
    nc_stage = len(programs[3].outs) if programs[3] is not None else 0
    nc_term = len(programs[4].outs) if programs[4] is not None else 0
    ineq = _rows(spec.ineq_mask[0]) if spec.nc else ()
    ineq_T = _rows(spec.ineq_mask[-1]) if spec.nc else ()
    if max(ineq + ineq_T, default=0) >= 64:
        raise Refused("an inequality row past row 63 (the kernels' inequality masks hold 64 rows)")
    dims = dict(programs=tuple(programs), nx=spec.nx, nu=spec.nu, nw=spec.npar,
                nc=spec.nc, nc_stage=nc_stage, nc_term=nc_term, ineq=ineq, ineq_T=ineq_T)
    stream = _ops_per_step(programs, spec.nx, spec.nu, nc_stage) >= STREAM_OPS
    body = print_header(**dims, stream=stream, struct="Generated")
    digest = hashlib.sha256(body.encode()).hexdigest()[:16]
    struct = f"Gen_{digest}"
    return GeneratedModel(**dims, stream=stream,
                          header=body.replace("struct Generated {", f"struct {struct} {{"),
                          name=f"gen_{digest}")
