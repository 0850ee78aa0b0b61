"""Device functions generated from torch stage functions
(iterativelqr_tpu_torch/ops/device_functions.py), on the CPU.

- The interpreted scalar program of every stage function equals the torch
  function to 1e-13 relative on random f64 inputs: all five objects of the
  six library models, examples/mpc_farm.py's and
  examples/sensitivity_demo.py's functions in torch, the problems of every
  elementwise function and of the mixed ops, and one function for each
  whitelisted op family (products and layout, constant indices and writes
  at them, the math functions, reductions).  The program reorders nothing
  but the terms of a sum, product or reduction (left to right; torch's CPU
  reduction and BLAS may pair them).
- The quadrotor written with matrices and the car as users write it equal
  the registered models' functions to 1e-12; a particle with quadratic-form
  costs is generated.
- The printed header compiles as host C++ (``__host__``/``__device__``
  defined empty) and, called through ctypes, gives the interpreter's values
  to 1e-13 (libm's sin and torch's may differ in the last bit).
- The generated acrobot counts its operations within 10% of
  chip_smoke.py's hand count, and ``kStream`` follows the hand headers.
- Refusals name the op or the cause (a data-dependent branch or shape,
  sorting, a matrix decomposition, an integer value).
- Tracing leaves no fake tensor in ``models/_const.py``'s cache.

Each op family against JAX's kernel evaluator is in
tests/test_torch_device_functions_jax.py; the solver-level parity with the
JAX package's interpret-mode K3/K4 in tests/test_torch_generated_solve.py
and tests/test_torch_generated_solve_ops.py.  Imports torch, numpy and the port.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch._subclasses.fake_tensor import FakeTensor
from torch_user_problems import (acrobot_lambdas, car_user, demo_problem, farm_problem,
                                 math_problem, mixed_problem, quadrotor_matrix)

from iterativelqr_tpu_torch import Constraint, Cost, Dynamics, build_spec
from iterativelqr_tpu_torch.models import _const, acrobot, car, cartpole, particle, pendulum, quadrotor
from iterativelqr_tpu_torch.ops import device_functions as df
from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk

torch.set_num_threads(1)

TOL = 1e-13
_SLOTS = ("dyn", "stage_cost", "term_cost", "stage_con", "term_con")


def _library_spec(name):
    mod = {"acrobot": acrobot, "car": car, "quadrotor": quadrotor, "particle": particle,
           "pendulum": pendulum, "cartpole": cartpole}[name]
    kw = {"device": "cpu"} if name in ("particle", "pendulum", "cartpole") else {}
    return build_spec(*mod.problem(9, **kw)[:3])


_SPECS = {
    **{m: (lambda m=m: _library_spec(m))
       for m in ("acrobot", "car", "quadrotor", "particle", "pendulum", "cartpole")},
    "farm": lambda: farm_problem(9), "demo": lambda: demo_problem(9),
    "math": lambda: math_problem(9), "mixed": lambda: mixed_problem(9),
}
_SPEC_CASES = [(s, i) for s in _SPECS for i in range(5)
               if not (s in ("acrobot", "particle", "pendulum", "farm", "demo") and i == 3)]

# one function per whitelisted op or op family (and what `where` and
# `clamp` bring), of (x [3], u [2], w [2])
_OP_CASES = {
    "add": lambda x, u, w: x + u[0] + 2,
    "sub": lambda x, u, w: x - w[1] - 0.5,
    "mul": lambda x, u, w: x * u[1] * 3.0,
    "div": lambda x, u, w: x / (2.0 + x * x) / 1.5,
    "neg": lambda x, u, w: -x,
    "rsub": lambda x, u, w: 1.0 - x,
    "pow": lambda x, u, w: torch.stack([x[0] ** 2, x[1] ** 3, x[2] ** 5, (1.5 + x[0] ** 2) ** -1,
                                        (1.5 + x[1] ** 2) ** -2, (1.5 + x[2] ** 2) ** 0.5,
                                        (1.5 + x[0] ** 2) ** -0.5]),
    "sin": lambda x, u, w: torch.sin(x),
    "cos": lambda x, u, w: torch.cos(x),
    "tan": lambda x, u, w: torch.tan(0.5 * x),
    "select": lambda x, u, w: x[2] * u[-1],
    "slice": lambda x, u, w: x[1:] + x[:2] + x[::2][0],
    "view": lambda x, u, w: torch.stack([x * w[0], x * w[1]]).reshape(6).view(2, 3)[1],
    "stack": lambda x, u, w: torch.stack([x[0], u[1], w[0]]),
    "cat": lambda x, u, w: torch.cat([x, u, w]),
    "sum": lambda x, u, w: torch.sum(torch.stack([x * u[0], x * u[1]]), dim=0)
    + torch.sum(x, 0, keepdim=True) + torch.sum(x * x),
    "dot": lambda x, u, w: torch.dot(u, w),
    "mv": lambda x, u, w: torch.tensor([[1.0, 0.5, -2.0], [0.0, 3.0, 1.25]],
                                       dtype=torch.float64).to(x) @ x,
    "exp": lambda x, u, w: torch.exp(x),
    "log": lambda x, u, w: torch.log(1.5 + x * x),
    "sqrt": lambda x, u, w: torch.sqrt(1.0 + x * x),
    "tanh": lambda x, u, w: torch.tanh(x),
    "abs": lambda x, u, w: torch.abs(x) + torch.abs(u[0]),
    "clamp": lambda x, u, w: torch.clamp(x, min=-0.5, max=0.5) + torch.clamp(x, min=w[0])
    + torch.clamp(x, max=0.25),
    "minimum": lambda x, u, w: torch.minimum(x, u[0]),
    "maximum": lambda x, u, w: torch.maximum(x, w[1]),
    "where": lambda x, u, w: torch.where(x > 0, x, 0.1 * x) + torch.where(x <= u[0], u[1], 2.0)
    + torch.where((x < w[0]) & (x >= -1.0) | ~(x == u[1]), 1.0, x) + (x != 0.3).to(x.dtype)
    + torch.where(torch.logical_or(x > 1.0, torch.logical_not(x < -1.0)), x, -x),
    "closure": lambda x, u, w: x - _GOAL,
    # matrix products and layout ops (their aten graphs: unsqueeze, mm and
    # squeeze_; permute and mv; einsum's permutes, views and bmm)
    "mm": lambda x, u, w: torch.cat([(x @ _Q.to(x) @ x).reshape(1), x @ _A.to(x),
                                     u @ _R.to(x) @ u[:, None]]),
    "permute": lambda x, u, w: _A.to(x).T @ x + torch.einsum("ij,j->i", _A.to(x), x)
    + _A.to(x).permute(1, 0)[2] * x[1],
    "bmm": lambda x, u, w: (x.reshape(1, 1, 3) @ _A.to(x).reshape(1, 3, 3)).reshape(3)
    + (torch.stack([x, 2.0 * x]) @ _A.to(x)).sum(0),
    "addmm": lambda x, u, w: torch.nn.functional.linear(x, _A.to(x)[:2], _BIAS.to(x)),
    "linalg_cross": lambda x, u, w: torch.linalg.cross(x, _A.to(x) @ x),
    "layout": lambda x, u, w: torch.cat([
        x[0].expand(3) + x, u.repeat(2), x[None].squeeze(0), _A.to(x).t()[0] * x,
        _A.to(x).transpose(0, 1)[1] * x, x.flip(0), torch.diagonal(_A.to(x)) * x,
        (lambda a, b, c: torch.stack([a * b, c]))(*x), x.split(2)[1], torch.diag(x) @ x]),
    # constant integer indices, writes at them, constant makers
    "index": lambda x, u, w: torch.cat([x[_IDX], x[[0, 2]], torch.index_select(x, 0, _IDX),
                                        torch.gather(x, 0, _IDX), (_A.to(x) * x)[:, _IDX][1],
                                        x[torch.arange(2)], x[torch.tensor([2, 0])]]),
    "writes": lambda x, u, w: _writes(x, u, w),
    # elementwise math
    "atan2": lambda x, u, w: torch.atan2(x, 1.0 + x * x) + torch.atan2(x - 0.5, x[0]),
    "sinh": lambda x, u, w: torch.sinh(x) + torch.cosh(x) + torch.asinh(x)
    + torch.acosh(1.5 + x * x) + torch.atanh(0.5 * torch.tanh(x)),
    "inverse trig": lambda x, u, w: torch.atan(x) + torch.asin(0.9 * torch.tanh(x))
    + torch.acos(0.5 * torch.tanh(x)),
    "sigmoid": lambda x, u, w: torch.sigmoid(x) + torch.nn.functional.softplus(x)
    + torch.nn.functional.softplus(30.0 * x) + torch.nn.functional.softplus(x, 2.0, 1.0),
    "log1p": lambda x, u, w: torch.log1p(x * x) + torch.expm1(x) + torch.erf(x),
    "rsqrt": lambda x, u, w: torch.rsqrt(1.0 + x * x) + torch.reciprocal(2.0 + x * x),
    "sign": lambda x, u, w: torch.sign(x) * x + torch.relu(x) + torch.sign(x - x),
    "hypot": lambda x, u, w: torch.hypot(x, u[0]) + torch.hypot(x, x),
    "pow (real exponent)": lambda x, u, w: (1.0 + x * x) ** 2.5 + torch.abs(x) ** 1.7
    + 2.0 ** x + (1.5 + x * x) ** (0.5 + u[0] * u[0]) + (1.0 + x * x) ** 20,
    # 0.0 * a and -0.0 * a are equal in Python but not under atan2: two
    # registers, not one
    "signed zero": lambda x, u, w: torch.stack([
        torch.atan2(0.0 * x[0], -1.0 - x[1] * x[1]), torch.atan2(-0.0 * x[0], -1.0 - x[1] * x[1])]),
    # reductions
    "amax": lambda x, u, w: torch.amax(_A.to(x) * x, 1) + torch.amin(_A.to(x) * x, 0)
    + torch.amax(x),
    "max": lambda x, u, w: torch.stack([torch.max(x), torch.min(x), torch.max(x, 0).values,
                                        torch.min(_A.to(x) * x, 1, keepdim=True).values[1, 0],
                                        torch.max(x, u[0])[1]]),
    "prod": lambda x, u, w: torch.prod(x) + torch.prod(_A.to(x) * x, 1) + torch.mean(x)
    + torch.mean(_A.to(x) * x, 0),
    "linalg_vector_norm": lambda x, u, w: torch.stack([
        torch.linalg.vector_norm(x), torch.linalg.vector_norm(x, 1),
        torch.linalg.vector_norm(x, float("inf")), torch.linalg.vector_norm(x, -float("inf")),
        torch.linalg.vector_norm(x, 3), torch.norm(u), *torch.linalg.vector_norm(
            _A.to(x) * x, dim=1, keepdim=True)[:, 0]]),
}
_GOAL = torch.tensor([0.5, -1.0, 2.0])
_rng = np.random.default_rng(5)
_A = torch.as_tensor(_rng.standard_normal((3, 3)))
_Q = torch.as_tensor(np.diag([1.0, 0.5, 2.0]) + 0.1)
_R = torch.diag(torch.tensor([0.3, 0.05], dtype=torch.float64))
_BIAS = torch.tensor([0.25, -1.5], dtype=torch.float64)
_IDX = torch.tensor([2, 0, 2])


def _writes(x, u, w):
    """Writes at constant indices and constant makers."""
    z = torch.zeros_like(x)
    z[1] = u[0]
    z[0:2] += w
    v = x.new_zeros(3).index_put((_IDX[:2],), u)
    y = (torch.ones(3, dtype=x.dtype) * 2.0 + torch.full((3,), 0.5, dtype=x.dtype)
         + torch.ones_like(x) + torch.zeros_like(x).fill_(0.25) + x.new_ones(3)
         + x.new_full((3,), -1.0) + torch.full_like(x, 3.0))
    e = (torch.eye(3, dtype=x.dtype) @ x + torch.arange(3, dtype=x.dtype) * x
         + torch.tensor([1, -2, 3]).to(x) * x)     # an integer constant cast to values
    return z + v + y + e


def _rand(rng, n, B=6):
    return torch.as_tensor(rng.standard_normal((n, B)))


def _per_instance(fn, x, u, w):
    """The torch function on each lane: [n_out, B]."""
    return torch.stack([fn(x[:, b], u[:, b], w[:, b]).reshape(-1)
                        for b in range(x.shape[1])], dim=-1)


def _close(out, ref, tol=TOL):
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= tol * scale, (out, ref)


def _program_case(case):
    """(function, n_x, n_u, n_w, terminal) of a parity case."""
    if case in _OP_CASES:
        return _OP_CASES[case], 3, 2, 2, False
    spec_name, slot = case
    o = df.stage_objects(_SPECS[spec_name]())[slot]
    return o._fn, o.num_state, o.num_action, o.num_parameter, slot in (2, 4)


@pytest.mark.parametrize("case", _SPEC_CASES + list(_OP_CASES),
                         ids=[f"{s}-{_SLOTS[i]}" for s, i in _SPEC_CASES] + list(_OP_CASES))
def test_program_equals_torch_function(case):
    fn, n_x, n_u, n_w, terminal = _program_case(case)
    prog = df.trace(fn, n_x, n_u, n_w, terminal=terminal)
    rng = np.random.default_rng(11)
    x, u, w = _rand(rng, n_x), _rand(rng, n_u), _rand(rng, n_w)
    if terminal:
        u = torch.zeros_like(u)   # the kernels' and the plain version's terminal u
    _close(df.run(prog, x, u, w), _per_instance(fn, x, u, w))
    # the f32 program rounds as the torch function does
    x32, u32, w32 = x.float(), u.float(), w.float()
    _close(df.run(prog, x32, u32, w32), _per_instance(fn, x32, u32, w32), 1e-6)


def _c_entry_points(model):
    struct = "Gen_" + model.name[len("gen_"):]
    return (f'#include "model.h"\nusing M = sl_models::{struct};\nextern "C" {{\n'
            "void c_dyn(const double* x, const double* u, const double* w, double* o)"
            " { M::dyn<double>(x, u, w, nullptr, o); }\n"
            "double c_stage_cost(const double* x, const double* u, const double* w)"
            " { return M::stage_cost<double>(x, u, w, nullptr); }\n"
            "double c_term_cost(const double* x, const double* u, const double* w)"
            " { (void)u; return M::term_cost<double>(x, w, nullptr); }\n"
            "void c_stage_con(const double* x, const double* u, const double* w, double* o)"
            " { M::stage_con<double>(x, u, w, nullptr, o); }\n"
            "void c_term_con(const double* x, const double* u, const double* w, double* o)"
            " { (void)u; M::term_con<double>(x, w, nullptr, o); }\n}\n")


def _ops_spec():
    """A spec whose dynamics use every whitelisted op."""
    def dyn(x, u):
        parts = [f(x, torch.cat([u, u]), x[:2]).reshape(-1) for f in _OP_CASES.values()]
        return x + 1e-3 * torch.tanh(torch.sum(torch.cat(parts)))
    return build_spec([Dynamics(dyn, 3, 1)] * 3, [Cost(lambda x, u: torch.dot(x, x), 3, 1)] * 4)


@pytest.mark.parametrize("name", ["acrobot", "car", "quadrotor", "cartpole", "farm", "demo",
                                  "ops", "math"])
def test_printed_header_compiles_and_matches(name, tmp_path):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    spec = _ops_spec() if name == "ops" else _SPECS[name]()
    model = df.generate(spec)
    (tmp_path / "model.h").write_text(model.header)
    (tmp_path / "entry.cc").write_text(_c_entry_points(model))
    lib_path = tmp_path / f"lib{name}.so"
    res = subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                          "-D__host__=", "-D__device__=", "-shared", "-fPIC",
                          "-o", str(lib_path), str(tmp_path / "entry.cc")],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(lib_path))
    rng = np.random.default_rng(12)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    for slot, prog in zip(_SLOTS, model.programs):
        if prog is None:
            continue
        fn = getattr(lib, f"c_{slot}")
        x = rng.standard_normal(spec.nx)
        u = np.zeros(spec.nu) if slot.startswith("term") else rng.standard_normal(spec.nu)
        w = rng.standard_normal(max(spec.npar, 1))
        want = df.run(prog, *(torch.as_tensor(a)[:, None] for a in (x, u, w)))[:, 0]
        if slot.endswith("cost"):
            fn.restype = ctypes.c_double
            got = torch.tensor([fn(ptr(x), ptr(u), ptr(w))], dtype=torch.float64)
        else:
            out = np.zeros(len(prog.outs))
            fn(ptr(x), ptr(u), ptr(w), ptr(out))
            got = torch.as_tensor(out)
        _close(got, want)


def test_acrobot_operation_count_and_ring():
    """The generated acrobot's operations a step within 10% of
    chip_smoke.py's hand count of the hand-written header; the ring choice
    (kStream) of every library model equals its hand header's."""
    import chip_smoke

    gen = df.generate(_library_spec("acrobot"))
    hand = chip_smoke.OPS_PER_STEP["acrobot"]
    assert abs(gen.ops_per_step() - hand) <= 0.1 * hand, (gen.ops_per_step(), hand)
    stream = {"acrobot": True, "quadrotor": True, "cartpole": True, "car": False,
              "particle": False, "pendulum": False}
    for name, want in stream.items():
        assert df.generate(_library_spec(name)).stream is want, name


_REFUSALS = {
    "sort": (lambda x, u, w: torch.sort(x).values, "aten.sort"),
    "inv": (lambda x, u, w: torch.linalg.inv(torch.outer(x, x) + torch.eye(2, dtype=x.dtype))
            @ x, "aten.linalg_inv_ex"),
    "branch": (lambda x, u, w: x if x[0] > 0 else -x, "data-dependent branch"),
    "integer": (lambda x, u, w: (x * 3).to(torch.int64).to(x.dtype), "dtype torch.int64"),
    "mask": (lambda x, u, w: x[x > 0].sum() * x, "boolean-mask indexing"),
    # torch.cat promotes the integers to values: refused, not read as indices
    "integer in cat": (lambda x, u, w: torch.cat([x, torch.tensor([1, 2])])[1:],
                       "lowers only as an index"),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_refusals_name_the_op(case):
    fn, what = _REFUSALS[case]
    with pytest.raises(df.Refused, match=what):
        df.trace(fn, 2, 1, 0)
    # in a spec: no device model, and the reason names the op too
    dyn = Dynamics(lambda x, u: fn(x, u, None), 2, 1, num_next_state=2)
    spec = build_spec([dyn] * 3, [Cost(lambda x, u: torch.dot(x, x), 2, 1)] * 4)
    assert fk.device_model(spec) is None
    assert what in fk.model_reason(spec) and "dyn" in fk.model_reason(spec)


def test_library_problems_keep_the_registry_and_user_problems_are_generated():
    for name in ("acrobot", "car", "quadrotor", "particle", "pendulum", "cartpole"):
        m = fk.device_model(_library_spec(name))
        assert m is not None and m.generated is None and m.name == name
    for spec in (acrobot_lambdas(9), farm_problem(9), demo_problem(9)):
        m = fk.device_model(spec)
        assert m.generated is not None and m.name == m.generated.name, fk.model_reason(spec)
    demo = fk.device_model(demo_problem(9)).generated
    assert demo.nw == 2 and "w[1]" in demo.header
    # the same functions give the same model (one library, keyed by its text)
    assert fk.device_model(acrobot_lambdas(11)).name == fk.device_model(acrobot_lambdas(9)).name


def test_tracing_leaves_no_fake_constant():
    """const_like under fake tracing: through the generator (which also
    saves and restores the cache) and straight through make_fx, the cast
    made while tracing is not kept; a later real call gets a real tensor."""
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(4))
    want = x - torch.tensor(acrobot.GOAL, dtype=torch.float64)
    _const._CACHE.clear()
    df.trace(lambda x, u, w: acrobot.goal_constraint(x, u), 4, 0, 0, terminal=True)
    _const._CACHE.clear()
    make_fx(acrobot.goal_constraint, tracing_mode="fake", _allow_non_fake_inputs=True)(
        torch.zeros(4, dtype=torch.float64), torch.zeros(0, dtype=torch.float64))
    assert not any(isinstance(v, FakeTensor) for v in _const._CACHE.values())
    got = acrobot.goal_constraint(x, torch.zeros(0, dtype=torch.float64))
    assert type(got) is torch.Tensor and not isinstance(got, FakeTensor)
    assert torch.equal(got, want)
    assert not any(isinstance(v, FakeTensor) for v in _const._CACHE.values())


def test_goal_constraint_with_constants_of_another_dtype():
    """A closed-over constant in torch's default f32 (examples/mpc_farm.py's
    goal) lowers to its exact values; an op computing in f32 refuses."""
    spec = farm_problem(9)
    goal = df.stage_objects(spec)[4]
    prog = df.trace(goal._fn, 2, 0, 0, terminal=True)
    assert prog.outs and all(name == "sub" for name, _ in prog.ops)
    c32 = torch.tensor([1.0, 2.0])
    with pytest.raises(df.Refused, match="dtype torch.float32"):
        df.trace(lambda x, u, w: x + c32 * c32, 2, 0, 0)


def test_empty_and_parameter_blocks():
    """A stage with an empty constraint block prints an empty function; a
    spec with per-step parameters reads them as w."""
    model = df.generate(demo_problem(9))
    assert model.programs[3] is None and model.nc_stage == 0 and model.nc_term == 2
    stage = model.programs[1]
    assert stage.n_w == 2 and any(a == stage.n_x + stage.n_u for _, args in stage.ops
                                  for a in args if not isinstance(a, float))
    T = 9
    dyn = Dynamics(lambda x, u: x + u, 2, 2)
    con = Constraint(lambda x, u: torch.cat([u - 1.0, -u - 1.0]), 2, 2,
                     indices_inequality=(0, 1, 2, 3))
    spec = build_spec([dyn] * (T - 1), [Cost(lambda x, u: torch.dot(u, u), 2, 2)] * T,
                      [con] * (T - 1) + [Constraint()])
    m = df.generate(spec)
    assert (m.nc, m.nc_stage, m.nc_term, m.ineq) == (4, 4, 0, (0, 1, 2, 3))
    assert "INEQ_STAGE = 15u" in m.header


@pytest.mark.parametrize("name", ["quadrotor_matrix", "car_user"])
def test_user_problem_programs_equal_the_registered_models(name):
    """The generated programs of models/quadrotor.py's and models/car.py's
    problems written as users write them (matrices, constant indexing,
    vector_norm) equal the registered hand-written models' functions to
    1e-12: the same math in another order of operations."""
    user = {"quadrotor_matrix": quadrotor_matrix, "car_user": car_user}[name](9)
    lib = _library_spec(name.split("_")[0])
    model = fk.device_model(user)
    assert model is not None and model.generated is not None, fk.model_reason(user)
    assert "generated" in fk.model_reason(user)
    gen = model.generated
    assert (gen.nx, gen.nu, gen.nc) == (lib.nx, lib.nu, lib.nc)
    assert (gen.ineq, gen.ineq_T) == (df._rows(lib.ineq_mask[0]), df._rows(lib.ineq_mask[-1]))
    rng = np.random.default_rng(13)
    x = 0.5 * _rand(rng, lib.nx)
    u = 0.5 * _rand(rng, lib.nu) + (2.4525 if name == "quadrotor_matrix" else 0.0)
    w = _rand(rng, 0)
    for slot, prog, o in zip(_SLOTS, gen.programs, df.stage_objects(lib)):
        uu = torch.zeros_like(u) if slot.startswith("term") else u
        _close(df.run(prog, x, uu, w), _per_instance(o._fn, x, uu, w), 1e-12)


def test_matrix_costs_are_generated():
    """A particle whose costs are quadratic forms 0.5 x @ Q @ x (the form
    the generator refused before it lowered products) gets a generated
    model, and its program equals the torch function."""
    Q = torch.tensor([[1.0, 0.1], [0.1, 0.5]], dtype=torch.float64)
    dyn, _, con, _, _ = particle.problem(9, device="cpu")
    stage = Cost(lambda x, u: 0.5 * x @ Q @ x + 0.05 * u @ u, 2, 1)
    term = Cost(lambda x, u: 0.5 * x @ Q @ x, 2, 0)
    spec = build_spec(dyn, [stage] * 8 + [term], con)
    assert "generated" in fk.model_reason(spec), fk.model_reason(spec)
    prog = fk.device_model(spec).generated.programs[1]
    rng = np.random.default_rng(14)
    x, u, w = _rand(rng, 2), _rand(rng, 1), _rand(rng, 0)
    _close(df.run(prog, x, u, w), _per_instance(stage._fn, x, u, w))
