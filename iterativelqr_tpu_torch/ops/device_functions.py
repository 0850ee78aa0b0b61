"""Device functions generated from a user's torch stage functions, for the
line-search rollout kernels K3/K4 (``csrc/sl_rollout.cuh``).

Counterpart of ``_Fns`` and ``_eval_jaxpr_no_dot`` in
``iterativelqr_tpu/ops/sl_forward_kernel.py``: there the user's stage
functions become jaxprs whose closed-over constants are hoisted into kernel
arguments, and the jaxpr is evaluated inside the Pallas body.  Here each of
the five stage objects the kernels call (dynamics, stage cost, terminal
cost, stage constraint, terminal constraint) is

1. **traced** with ``make_fx(..., tracing_mode="fake")`` on f64 inputs
   ``(x [num_state], u [num_action], w [num_parameter])``: an aten graph;
2. **lowered** to a scalar program, a straight-line list of scalar
   operations over numbered registers.  Shapes are fixed, so ``select``,
   ``slice``, ``view``, ``unsqueeze``, ``stack`` and ``cat`` only rename
   registers; ``sum``, ``dot`` and ``mv`` unroll left to right; ``pow``
   with an integer exponent becomes products as torch forms them; a
   closed-over tensor becomes literals (``T(<repr of the f64>)``, cast to
   the solve's dtype as ``const_like`` casts it).  Identical operations on
   identical registers share one register (exact: each is a pure
   function of its inputs), and ``x * 1.0`` is ``x``;
3. **printed** as a CUDA header of the form of ``csrc/sl_model_*.cuh``: a
   struct with the dims, the inequality rows, ``kStream`` and
   ``template <typename T> __host__ __device__`` functions.

``run`` interprets a scalar program with torch ops on the CPU, the way
``interpret=True`` stands in for a Pallas kernel (the tests hold it against
the traced functions, and the printed header against it).

Only the operations of ``WHITELIST`` lower.  Anything else refuses with
``Refused``, whose message names the op: an op outside the whitelist, a
branch on a traced value (``GuardOnDataDependentSymNode``), or a value whose
dtype is not the input's.  ``ops/sl_forward_kernel.py`` keeps the message
as the spec's ``model_reason``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..models import _const

# aten ops (overload packet names) that lower to scalar operations
WHITELIST = (
    "add", "sub", "mul", "div", "neg", "rsub", "pow", "sin", "cos", "tan",
    "select", "slice", "view", "stack", "cat", "sum", "dot", "mv",
    "lift_fresh_copy",
    "exp", "log", "sqrt", "tanh", "abs", "clamp", "minimum", "maximum",
    "where",
    # what `where`, `clamp` and literals bring with them
    "gt", "ge", "lt", "le", "eq", "ne", "bitwise_and", "bitwise_or",
    "bitwise_not", "logical_and", "logical_or", "logical_not", "scalar_tensor", "clamp_min",
    "clamp_max", "unsqueeze", "_unsafe_view", "clone", "_to_copy",
)

# Operations per scalar op for a bound (chip_smoke.py's rule: each add,
# multiply or divide 1, each sin, cos or tan 20; the other transcendental
# functions as sin; a comparison, select or min/max 1; a condition's cast
# to 0 or 1 and renaming 0)
_TRANSCENDENTAL = ("sin", "cos", "tan", "exp", "log", "tanh")

_UNARY = ("neg", "sin", "cos", "tan", "exp", "log", "sqrt", "tanh", "abs")
_COMPARE = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==",
            "ne": "!="}
_ARITH = {"add": "+", "sub": "-", "mul": "*", "div": "/"}
# conditions: (aten op, scalar op, C operator)
_LOGIC = {"bitwise_and": "and", "logical_and": "and", "bitwise_or": "or",
          "logical_or": "or", "bitwise_not": "not", "logical_not": "not"}
_C_LOGIC = {"and": "&&", "or": "||"}
# ops that only rename registers
_RENAMES = ("select", "slice", "view", "_unsafe_view", "unsqueeze", "stack",
            "cat", "lift_fresh_copy", "clone", "_to_copy")


class Refused(ValueError):
    """A stage function that cannot become a device function; the message
    names the op or the data-dependent branch."""


def _is_lit(a) -> bool:
    return isinstance(a, float)


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
        key = (name, tuple((_is_lit(a), a) for a in args))
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


def _sequential_sum(b, terms):
    acc = None
    for t in terms:
        acc = t if acc is None else b.emit("add", acc, t)
    return 0.0 if acc is None else acc


def _pow(b, a, e):
    """torch's pow(x, e) for the exponents it forms from products or a
    square root (aten's pow_tensor_scalar_optimized)."""
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
    raise Refused(f"aten.pow with exponent {e!r} (integer exponents up to 16, "
                  "+-0.5, -1 and -2 lower)")


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
                env[node] = _obj(self.call(node.target, args, kwargs))
                self.check_dtype(node, env[node])
            elif node.op == "output":
                out = self.arg(env, node.args[0])
            else:
                raise Refused(f"graph node {node.op} {node.target}")
        if isinstance(out, (list, tuple)):
            if len(out) != 1:
                raise Refused("a stage function returns one tensor")
            out = out[0]
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
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            raise Refused(f"constant {name} is not a floating-point tensor")
        vals = t.detach().to("cpu", torch.float64).numpy()
        return np.vectorize(float, otypes=[object])(vals) if vals.ndim else _obj(float(vals))

    @staticmethod
    def check_dtype(node, out):
        """Every value is the input's f64 (or a condition), but for a
        renaming of a closed-over constant of another float dtype (its
        values are exact in f64, and an op that meets the input promotes
        them as T does)."""
        val = node.meta.get("val")
        if not isinstance(val, torch.Tensor) or val.dtype in (torch.float64, torch.bool):
            return
        if (node.target.overloadpacket.__name__ in _RENAMES and val.is_floating_point()
                and all(_is_lit(a) for a in out.reshape(-1))):
            return
        raise Refused(f"{node.target} gives dtype {val.dtype}, not the input's "
                      "torch.float64")

    def call(self, target, args, kw):
        name = target.overloadpacket.__name__ if hasattr(target, "overloadpacket") else str(target)
        if name not in WHITELIST:
            raise Refused(f"{target} is not among the ops that lower to device "
                          f"functions ({', '.join(WHITELIST)})")
        b = self.b
        if name in ("lift_fresh_copy", "clone"):
            return args[0]
        if name == "_to_copy":
            # a move or a cast to the input's dtype (a cast to another dtype
            # is refused by check_dtype); a condition becomes 0 or 1
            return _elementwise(b.as_float, args[0])
        if name == "scalar_tensor":
            return _obj(_lit(args[0]))
        if name in _ARITH or name == "rsub":
            alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
            if alpha != 1 or kw.get("rounding_mode") is not None:
                raise Refused(f"{target} with alpha or rounding_mode")
            x, y = (_obj(a if isinstance(a, np.ndarray) else _lit(a)) for a in args[:2])
            if name == "rsub":
                name, x, y = "sub", y, x
            return _elementwise(lambda p, q: b.emit(name, b.as_float(p), b.as_float(q)), x, y)
        if name in _UNARY:
            return _elementwise(lambda p: b.emit(name, b.as_float(p)), args[0])
        if name == "pow":
            if not isinstance(args[0], np.ndarray) or isinstance(args[1], np.ndarray):
                raise Refused(f"{target}: only tensor ** scalar lowers")
            return _elementwise(lambda p: _pow(b, p, _lit(args[1])), args[0])
        if name in ("minimum", "maximum"):
            op = "min" if name == "minimum" else "max"
            return _elementwise(lambda p, q: b.emit(op, b.as_float(p), b.as_float(q)),
                                *(_obj(a) for a in args[:2]))
        if name in ("clamp", "clamp_min", "clamp_max"):
            lo = args[1] if len(args) > 1 else kw.get("min")
            hi = args[2] if len(args) > 2 else kw.get("max")
            if name == "clamp_max":
                lo, hi = None, lo
            out = args[0]
            if lo is not None:
                lo = _obj(lo if isinstance(lo, np.ndarray) else _lit(lo))
                out = _elementwise(lambda p, q: b.emit("max", b.as_float(p), q), out, lo)
            if hi is not None:
                hi = _obj(hi if isinstance(hi, np.ndarray) else _lit(hi))
                out = _elementwise(lambda p, q: b.emit("min", b.as_float(p), q), out, hi)
            return out
        if name in _COMPARE:
            y = _obj(args[1] if isinstance(args[1], np.ndarray) else _lit(args[1]))
            return _elementwise(lambda p, q: b.emit(name, b.as_float(p), b.as_float(q),
                                                    kind="b"), args[0], y)
        if name in _LOGIC:
            op = _LOGIC[name]

            def cond(*ps):
                if any(b.kind(p) != "b" for p in ps):
                    raise Refused(f"{target} on a value that is not a condition")
                return b.emit(op, *ps, kind="b")

            return _elementwise(cond, *args[: 1 if op == "not" else 2])
        if name == "where":
            c, x, y = (_obj(a if isinstance(a, np.ndarray) else _lit(a)) for a in args[:3])

            def sel(p, q, r):
                if b.kind(p) != "b":
                    p = b.emit("ne", p, 0.0, kind="b")
                return b.emit("where", p, b.as_float(q), b.as_float(r))

            return _elementwise(sel, c, x, y)
        if name == "select":
            a, dim, i = args
            return np.take(a, i, axis=dim)
        if name == "slice":
            a, dim = args[0], args[1] if len(args) > 1 else 0
            start = args[2] if len(args) > 2 else None
            end = args[3] if len(args) > 3 else None
            step = args[4] if len(args) > 4 else 1
            sl = [slice(None)] * a.ndim
            sl[dim] = slice(start, end, step)
            return a[tuple(sl)]
        if name in ("view", "_unsafe_view"):
            return np.asarray(args[0], dtype=object).reshape(args[1])
        if name == "unsqueeze":
            return np.expand_dims(args[0], args[1])
        if name in ("stack", "cat"):
            dim = args[1] if len(args) > 1 else kw.get("dim", 0)
            parts = [np.asarray(p, dtype=object) for p in args[0]]
            return (np.stack if name == "stack" else np.concatenate)(parts, axis=dim)
        if name == "sum":
            if kw.get("dtype") is not None or (len(args) > 3 and args[3] is not None):
                raise Refused(f"{target} with a dtype")
            a = np.asarray(args[0], dtype=object)
            dims = args[1] if len(args) > 1 else kw.get("dim")
            keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
            if dims is None or dims == []:
                dims = list(range(a.ndim))
            dims = sorted(d % a.ndim for d in ([dims] if isinstance(dims, int) else dims))
            rest = [d for d in range(a.ndim) if d not in dims]
            moved = np.transpose(a, rest + dims)
            flat = moved.reshape([a.shape[d] for d in rest] + [-1])
            out = np.empty(flat.shape[:-1], dtype=object)
            for idx in np.ndindex(out.shape):
                out[idx] = _sequential_sum(b, [b.as_float(t) for t in flat[idx]])
            if keep:
                for d in dims:
                    out = np.expand_dims(out, d)
            return out
        if name == "dot":
            x, y = args
            return _obj(_sequential_sum(b, [b.emit("mul", b.as_float(p), b.as_float(q))
                                            for p, q in zip(x, y)]))
        if name == "mv":
            A, x = args
            out = np.empty(A.shape[0], dtype=object)
            for i in range(A.shape[0]):
                out[i] = _sequential_sum(b, [b.emit("mul", b.as_float(p), b.as_float(q))
                                             for p, q in zip(A[i], x)])
            return out
        raise Refused(f"{target}: no lowering")  # a whitelisted op's other overload


def trace(fn: Callable, n_x: int, n_u: int, n_w: int, *, terminal: bool = False,
          device="cpu") -> Program:
    """The scalar program of ``fn(x [n_x], u [n_u], w [n_w])``, traced with
    fake f64 tensors on ``device`` (the solve's: a closed-over constant
    lives there).  ``terminal``: the kernels call it with u = 0 (a terminal
    cost or constraint), so u becomes literal zeros.  Raises ``Refused``."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode

    z = lambda n: torch.zeros(n, dtype=torch.float64, device=device)
    saved = dict(_const._CACHE)
    try:
        gm = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(
            z(n_x), z(n_u), z(n_w))
    except GuardOnDataDependentSymNode as e:
        raise Refused("a data-dependent branch (Python control flow on a traced "
                      f"value): {str(e).splitlines()[0]}") from None
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
        elif name in _UNARY:
            e = f"{name}({a[0]})"
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
    return f"{sum(1 << i for i in rows)}u"


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
        "#endif",
        "",
        f"struct {struct} {{",
        f"  static constexpr int NX = {nx}, NU = {nu}, NW = {nw}, NP = 0;",
        f"  static constexpr int NC_STAGE = {nc_stage}, NC_TERM = {nc_term};",
        f"  static constexpr int NC = {nc};",
        f"  static constexpr unsigned INEQ_STAGE = {_mask(ineq)}, INEQ_TERM = {_mask(ineq_T)};",
        f"  static constexpr bool kStream = {'true' if stream else 'false'};",
        "",
        "  // torch.minimum / torch.maximum: NaN in either operand gives NaN",
        "  template <typename T>",
        "  __host__ __device__ static T gmin(T a, T b) { return (a != a || b != b) ? a + b : (b < a ? b : a); }",
        "  template <typename T>",
        "  __host__ __device__ static T gmax(T a, T b) { return (a != a || b != b) ? a + b : (b > a ? b : a); }",
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
    dims = dict(programs=tuple(programs), nx=spec.nx, nu=spec.nu, nw=spec.npar,
                nc=spec.nc, nc_stage=nc_stage, nc_term=nc_term, ineq=ineq, ineq_T=ineq_T)
    stream = _ops_per_step(programs, spec.nx, spec.nu, nc_stage) >= STREAM_OPS
    body = print_header(**dims, stream=stream, struct="Generated")
    digest = hashlib.sha256(body.encode()).hexdigest()[:16]
    struct = f"Gen_{digest}"
    return GeneratedModel(**dims, stream=stream,
                          header=body.replace("struct Generated {", f"struct {struct} {{"),
                          name=f"gen_{digest}")
