"""The derive kernel's programs (iterativelqr_tpu_torch/ops/derive_kernel.py,
csrc/sl_derive.cuh) against the plain derive of the SL loop, the
``torch.func`` stacks of ``ops/packed_pipeline.py::make_plain_stacks``.

On the CPU:
- For every library model and every user problem of
  tests/torch_user_problems.py (one with every derivative written by hand),
  the stage and terminal programs, interpreted by
  ``device_functions.run`` in f64, give the plain stacks to 1e-12 of
  max(1, |plain|), padded rows included.
- The printed header compiles as host C++ (``__host__``/``__device__``
  defined empty) and, called through ctypes, gives the interpreter's values.
- A spec whose stage types differ across steps, and one whose function
  branches on a value, have no derive model and say why; the SL step built
  for them keeps the plain stacks.
- The counters ``sl_derive`` and ``derive.plain`` are listed.

Marked ``cuda`` (skip here): every library model and the quadrotor team
have derive programs on the card's torch (a torch whose graphs hold an op
the lowering lacks fails here, not as a quiet turn to the plain stacks);
a spec without them warns when its SL step is built; the kernel's stacks
against the plain stacks on the same inputs at B=4096 in f32 and f64 for
the car, the acrobot, the quadrotor and the quadrotor team (36, 12); and
an SL solve on the card that launches the kernel on every trip and never
the plain stacks.  On a
machine with a card and without JAX, run them with

    python -m pytest tests/test_torch_derive_kernel.py --noconftest -o addopts="" -q

This file imports torch, numpy and the port only.
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch
import iterativelqr_tpu_torch as P
from torch_user_problems import (acrobot_lambdas, car_user, demo_problem, farm_problem,
                                 math_problem, mixed_problem, pendulum_manual, planar_quadrotor,
                                 quadrotor_matrix, quadrotor_team)

from iterativelqr_tpu_torch import Cost, Dynamics, Options, build_spec
from iterativelqr_tpu_torch.models import acrobot, car, cartpole, particle, pendulum, quadrotor
from iterativelqr_tpu_torch.ops import derive_kernel as dk
from iterativelqr_tpu_torch.ops import device_functions as df
from iterativelqr_tpu_torch.ops import packed_pipeline as pp
from iterativelqr_tpu_torch.utils import profiling

torch.set_num_threads(1)

_LIBRARY = {"car": car, "acrobot": acrobot, "cartpole": cartpole, "pendulum": pendulum,
            "particle": particle, "quadrotor": quadrotor}


def _library(name, T, device="cpu"):
    kw = {"device": device} if name in ("particle", "pendulum", "cartpole") else {}
    return build_spec(*_LIBRARY[name].problem(T, **kw)[:3])


_SPECS = {
    **{name: (lambda name=name: _library(name, 7)) for name in _LIBRARY},
    "acrobot (lambdas)": lambda: acrobot_lambdas(7),
    "farm": lambda: farm_problem(7), "demo (w)": lambda: demo_problem(7),
    "math": lambda: math_problem(7), "mixed": lambda: mixed_problem(7),
    "quadrotor (matrices)": lambda: quadrotor_matrix(7), "car (user)": lambda: car_user(7),
    "planar quadrotor": lambda: planar_quadrotor(P, torch, T=7),
    "team (36, 12)": lambda: quadrotor_team(P, torch, T=4),
    "pendulum (manual derivatives)": lambda: pendulum_manual(7),
}


def _inputs(spec, B, seed=3, dtype=torch.float64, device="cpu"):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor(0.4 * rng.standard_normal(shape)).to(device, dtype)
    return mk(spec.T, spec.nx, B), mk(spec.T - 1, spec.nu, B), mk(spec.T, spec.npar, B)


def _close(got, want, tol):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        scale = max(1.0, float(b.double().abs().max()))
        assert float((a.double() - b.double()).abs().max()) <= tol * scale


def _split(flat, names, dims, rows, B) -> list:
    """[n_out, rows, B] program outputs -> the stacks [rows, *dims, B]."""
    out, lo = [], 0
    for name in names:
        d = dims[name]
        n = math.prod(d)
        out.append(flat[lo:lo + n].reshape(*d, rows, B).movedim(-2, 0))
        lo += n
    return out


def _interpret(model, xs, us, ws) -> tuple:
    """The kernel's stacks with its programs interpreted by
    ``device_functions.run`` (the CPU's stand-in for the kernel):
    xs [T,nx,B], us [T-1,nu,B], ws [T,nw,B] -> (fx, fu, gx, gu, gxx, guu,
    gux[, cx, cu]), gx, gxx and cx with T rows."""
    T, B = xs.shape[0], xs.shape[-1]
    dims = dk.stack_dims(model.nx, model.nu, model.nc)
    names = dk.stack_names(model.nc)
    tr = lambda a: a.transpose(0, 1)
    stage = df.run(model.stage, tr(xs[:-1]), tr(us), tr(ws[:-1]))
    term = df.run(model.terminal, xs[-1], us.new_zeros((model.nu, B)), ws[-1])
    stacks = dict(zip(names, _split(stage, names, dims, T - 1, B)))
    term_names = dk.terminal_names(model.nc)
    for name, a in zip(term_names, _split(term, term_names, dims, 1, B)):
        stacks[name] = torch.cat([stacks[name], a])
    return tuple(stacks[n] for n in names)


@pytest.mark.parametrize("name", list(_SPECS))
def test_programs_equal_the_torch_func_stacks(name):
    spec = _SPECS[name]()
    model = dk.derive_model(spec)
    assert model is not None, dk.derive_reason(spec)
    xs, us, ws = _inputs(spec, B=5)
    want = pp.make_plain_stacks(spec)(xs, us, ws)
    got = _interpret(model, xs, us, ws)
    assert len(got) == len(dk.stack_names(spec.nc))
    _close(got, want, 1e-12)


def _host_entry(model):
    struct = "Derive_" + model.name[len("derive_"):]
    return ('#include "derive.h"\n'
            f"using M = sl_models::{struct};\n"
            "struct Flat {\n  double* out; const int* at;\n"
            "  void operator()(int k, int j, double v) const { out[at[k] + j] = v; }\n};\n"
            'extern "C" {\n'
            "void c_stage(const double* x, const double* u, const double* w, double* o,"
            " const int* at) { M::stage<double>(x, u, w, Flat{o, at}); }\n"
            "void c_terminal(const double* x, const double* w, double* o, const int* at)"
            " { M::terminal<double>(x, w, Flat{o, at}); }\n}\n")


def _offsets(spec, names):
    """Where each stack's entries start in a program's flat outputs, by the
    kernel's stack index."""
    dims = dk.stack_dims(spec.nx, spec.nu, spec.nc)
    at, lo = [0] * len(dk.STACKS), 0
    for name in names:
        at[dk.STACKS.index(name)] = lo
        lo += int(np.prod(dims[name]))
    return (ctypes.c_int * len(at))(*at)


@pytest.mark.parametrize("name", ["car", "quadrotor", "math", "pendulum (manual derivatives)"])
def test_printed_header_compiles_and_matches(name, tmp_path):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    spec = _SPECS[name]()
    model = dk.derive_model(spec)
    (tmp_path / "derive.h").write_text(model.header)
    (tmp_path / "entry.cc").write_text(_host_entry(model))
    lib_path = tmp_path / "libderive.so"
    res = subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                          "-D__host__=", "-D__device__=", "-shared", "-fPIC",
                          "-o", str(lib_path), str(tmp_path / "entry.cc")],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(lib_path))
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rng = np.random.default_rng(4)
    x, u, w = (rng.standard_normal(max(n, 1)) for n in (spec.nx, spec.nu, spec.npar))
    col = lambda a, n: torch.as_tensor(a[:n])[:, None]
    names = dk.stack_names(spec.nc)
    for prog, fn, args, which in (
            (model.stage, lib.c_stage, (x, u, w), names),
            (model.terminal, lib.c_terminal, (x, w), dk.terminal_names(spec.nc))):
        out = np.zeros(len(prog.outs))
        fn(*(ptr(a) for a in args), ptr(out), _offsets(spec, which))
        want = dk.df.run(prog, col(x, spec.nx), col(u, spec.nu), col(w, spec.npar))[:, 0]
        scale = max(1.0, float(want.abs().max()))
        assert float((torch.as_tensor(out) - want).abs().max()) <= 1e-13 * scale


def _branching(T):
    """A dynamics function with a Python branch on a state's value."""
    dyn = Dynamics(lambda x, u: x + 0.1 * u if x[0] > 0 else x - 0.1 * u, 1, 1)
    cost = Cost(lambda x, u: torch.sum(x * x) + torch.sum(u * u), 1, 1)
    term = Cost(lambda x, u: torch.sum(x * x), 1, 0)
    return build_spec([dyn] * (T - 1), [cost] * (T - 1) + [term])


def _mixed_stages(T):
    """Two stage costs along the horizon: not one combined stage type."""
    dyn = Dynamics(lambda x, u: x + 0.1 * u, 1, 1)
    a = Cost(lambda x, u: torch.sum(x * x) + torch.sum(u * u), 1, 1)
    b = Cost(lambda x, u: 2.0 * torch.sum(x * x) + torch.sum(u * u), 1, 1)
    term = Cost(lambda x, u: torch.sum(x * x), 1, 0)
    return build_spec([dyn] * (T - 1), [a, b] * ((T - 1) // 2) + [term])


@pytest.mark.parametrize("make, why", [(_mixed_stages, "stage types differ across steps"),
                                       (_branching, "data-dependent branch")])
def test_refusals_keep_the_plain_stacks_and_say_why(make, why):
    spec = make(5)
    assert dk.derive_model(spec) is None
    assert why in dk.derive_reason(spec), dk.derive_reason(spec)
    if why == "data-dependent branch":
        return      # torch.func's vmap refuses the branch too: no route solves it
    step = pp.make_derive_backward_sl(spec, Options(), device="cpu")
    xs, us, ws = _inputs(spec, B=3)
    zero = xs.new_zeros((spec.T, spec.nc, 3))
    K, *_ = step(xs, us, ws, zero, zero, zero, xs.new_zeros(3))
    assert K.shape == (spec.T - 1, spec.nu, spec.nx, 3)


def test_counters_are_listed():
    counts = profiling.counters()
    assert counts["sl_derive"] == dk.DERIVE_LAUNCHES.launches
    assert counts["derive.plain"] == dk.PLAIN_DERIVES.launches


# --- on the card ----------------------------------------------------------

_CARD = {"car": lambda: _library("car", 51), "acrobot": lambda: _library("acrobot", 101),
         "quadrotor": lambda: _library("quadrotor", 41),
         "team (36, 12)": lambda: quadrotor_team(P, torch, T=41)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*_LIBRARY, "team (36, 12)"])
def test_library_models_have_derive_programs_on_the_card(name):
    """The lowering holds every op of the card's torch's jacfwd and grad
    graphs for each library model and the team, so their solves on the
    card derive on the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = (quadrotor_team(P, torch, T=4) if name == "team (36, 12)"
            else _library(name, 7, device="cuda"))
    assert dk.derive_model(spec, "cuda") is not None, dk.derive_reason(spec, "cuda")


@pytest.mark.cuda
def test_plain_derive_on_the_card_warns():
    """A spec without derive programs (stage types that differ) still
    solves on the card, on the plain stacks, and building its SL step says
    so with the reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = _mixed_stages(5)
    with pytest.warns(RuntimeWarning, match="stage types differ across steps"):
        pp.make_derive_backward_sl(spec, Options(), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", list(_CARD))
def test_kernel_matches_the_plain_stacks_on_the_card(name, dtype, tol):
    """The nine stacks (gx, gxx and cx with the terminal row) at B=4096 on
    the same inputs.  The two evaluate the same functions in other orders
    (the plain stacks' batched gemv sums in its own), so f32 differs by
    rounding: 1e-5 of max(1, |plain|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = _CARD[name]()
    model = dk.derive_model(spec, "cuda")
    assert model is not None, dk.derive_reason(spec, "cuda")
    args = _inputs(spec, B=4096, dtype=dtype, device="cuda")
    before = dk.DERIVE_LAUNCHES.launches
    got = dk.derive_stacks(model, *args)
    assert dk.DERIVE_LAUNCHES.launches == before + 1
    _close(got, pp.make_plain_stacks(spec)(*args), tol)


@pytest.mark.cuda
def test_sl_solve_launches_the_kernel_every_trip():
    """A car solve on the card (B=256, T=51, f32) derives with the kernel
    on every trip and once more in ``finish``, and never with the plain
    stacks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = _library("car", 51)
    B = 256
    rng = np.random.default_rng(0)
    u0 = torch.stack(car.initial_controls(51)).float().cuda()
    us = u0.expand(B, -1, -1).contiguous()
    xs = torch.zeros((B, 51, 3), dtype=torch.float32, device="cuda")
    xs[:, 0] = torch.as_tensor(0.02 * rng.standard_normal((B, 3)), dtype=torch.float32).cuda()
    step = torch.func.vmap(spec.dyn_eval[0])
    for t in range(50):
        xs[:, t + 1] = step(xs[:, t], us[:, t], xs.new_zeros((B, 0)))
    solve = P.make_batched_solve_fn(spec, Options(record_traces=False), device="cuda")
    launches, plain = dk.DERIVE_LAUNCHES.launches, dk.PLAIN_DERIVES.launches
    solve(xs, us, xs.new_zeros((B, 51, 0)))
    trips = profiling.solve_log()[-1]["trips"]
    assert trips > 0
    assert dk.PLAIN_DERIVES.launches == plain
    assert dk.DERIVE_LAUNCHES.launches - launches == trips + 1
