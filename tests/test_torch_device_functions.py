"""Device functions generated from torch stage functions
(iterativelqr_tpu_torch/ops/device_functions.py), on the CPU.

- The interpreted scalar program of every stage function equals the torch
  function to 1e-13 relative on random f64 inputs: all five objects of the
  six library models, examples/mpc_farm.py's and
  examples/sensitivity_demo.py's functions in torch, and one function for
  each whitelisted op.  The program reorders nothing but the terms of a
  sum, dot or mv (left to right; torch's CPU reduction may pair them).
- The printed header compiles as host C++ (``__host__``/``__device__``
  defined empty) and, called through ctypes, gives the interpreter's values
  to 1e-13 (libm's sin and torch's may differ in the last bit).
- The generated acrobot counts its operations within 10% of
  chip_smoke.py's hand count, and ``kStream`` follows the hand headers.
- Refusals name the op or the data-dependent branch.
- Tracing leaves no fake tensor in ``models/_const.py``'s cache.

The solver-level parity with the JAX package's interpret-mode K3/K4 is in
tests/test_torch_generated_solve.py.  Imports torch, numpy and the port.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch._subclasses.fake_tensor import FakeTensor
from torch_user_problems import acrobot_lambdas, demo_problem, farm_problem

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
}
_SPEC_CASES = [(s, i) for s in _SPECS for i in range(5)
               if not (s in ("acrobot", "particle", "pendulum", "farm", "demo") and i == 3)]

# one function per whitelisted op (and what `where` and `clamp` bring),
# of (x [3], u [2], w [2])
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
}
_GOAL = torch.tensor([0.5, -1.0, 2.0])


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
                                  "ops"])
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
    "sinh": (lambda x, u, w: torch.sinh(x), "aten.sinh"),
    "atan2": (lambda x, u, w: torch.atan2(x, 1.0 + x * x), "aten.atan2"),
    "branch": (lambda x, u, w: x if x[0] > 0 else -x, "data-dependent branch"),
    "integer": (lambda x, u, w: (x * 3).to(torch.int64).to(x.dtype), "dtype torch.int64"),
    "pow": (lambda x, u, w: (1.0 + x * x) ** 2.5, "exponent 2.5"),
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
