#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (iterativelqr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and nvcc.
Phases, each of which raises (non-zero exit) when it fails:

1. identity: card name and power limit, torch / CUDA / nvcc versions;
2. build: compiles the port's kernels from csrc/ (timed);
3. K1 (csrc/riccati_backward.cu) against its plain PyTorch version on the
   card at the main path's shapes (acrobot n=4, m=1, T=101, B=4096), in f64
   and f32, plus a batch with indefinite Quu on some lanes (ok = 0);
   median times of both;
4. the slice end to end: make_batched_solve_fn + batch_stats on acrobot
   T=101, B=4096, f32, under the bench.py presets "tuned" and "parity", with
   bench.py's initial-guess protocol; solved fraction from batch_stats and
   recomputed from the returned trajectories with constraint_values; K1
   launches counted over the timed solve; the per-iteration split of
   derive+backward against line search;
5. reference checks on small inputs: the card against the port's plain CPU
   path (acrobot T=9, B=4, f64: equal iterates), and the committed golden
   T=101 acrobot solution (tests/fixtures/golden_acrobot_T101.npz, f64).

The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T_MAIN, B_MAIN = 101, 4096
SEED = 0
SPLIT_ITERATIONS = 20

TUNED = dict(verbose=False, record_traces=False,
             initial_constraint_penalty=1000.0, min_step_size=4.0e-3,
             early_round_iteration_cap=20)
PARITY = dict(verbose=False, record_traces=False)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn()`` on the card, each run bracketed by
    synchronisation."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: K1 against its plain version
# ---------------------------------------------------------------------------


def random_stacks(seed, B, Tm1, n, m):
    """Well-conditioned batch-last derivative stacks (numpy, f64)."""
    rng = np.random.default_rng(seed)
    T = Tm1 + 1
    fx = 0.1 * rng.standard_normal((Tm1, n, n, B)) + np.eye(n)[None, :, :, None]
    fu = 0.1 * rng.standard_normal((Tm1, n, m, B))
    gx = rng.standard_normal((T, n, B))
    gu = rng.standard_normal((Tm1, m, B))
    A = rng.standard_normal((T, n, n, B))
    gxx = np.einsum("tikb,tjkb->tijb", A, A) / n + 0.1 * np.eye(n)[None, :, :, None]
    guu = 0.1 + np.abs(rng.standard_normal((Tm1, m, m, B)))
    gux = 0.05 * rng.standard_normal((Tm1, m, n, B))
    return [fx, fu, gx, gu, gxx, guu, gux]


def check_k1(pk):
    """K1 = plain within tolerance, ok equal, in f64 and f32; returns the
    f32 record at the main path's shapes."""
    B, Tm1, n, m = B_MAIN, T_MAIN - 1, 4, 1
    # f64: both sides are IEEE f64 summing 4-term products in other orders
    # (the kernel also contracts to FMA): 1e-10 relative.  f32: the same
    # differences at f32 rounding, carried through a 100-step recursion
    # (f32 against f64 of the plain version differs by ~1e-6 relative on
    # these stacks): 1e-4 relative.
    tols = {torch.float64: 1e-10, torch.float32: 1e-4}
    record = {}
    for case in ("well_conditioned", "indefinite_lanes"):
        st = random_stacks(SEED, B, Tm1, n, m)
        bad = np.zeros(B, bool)
        if case == "indefinite_lanes":
            bad[::61] = True
            st[5][50, 0, 0, bad] = -1.0e3
        for dtype, tol in tols.items():
            dev = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in st]
            kin = pk.prepare_stacks(*dev, torch.ones((Tm1, m), dtype=torch.bool))
            kin = [a.contiguous() for a in kin]
            reg = torch.zeros(B, dtype=dtype, device="cuda")
            out = pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
            ref = pk.backward_pass_multiref_reference(kin[:7], kin[7], kin[8], reg)
            torch.cuda.synchronize()
            max_abs = 0.0
            for name, a, b in zip(("K", "k", "Qx", "Qu", "p", "ok"), out, ref):
                nan_a, nan_b = torch.isnan(a), torch.isnan(b)
                if not torch.equal(nan_a, nan_b):
                    raise AssertionError(f"K1 {case} {dtype} {name}: NaN positions differ")
                fa, fb = a[~nan_b], b[~nan_b]
                scale = float(fb.abs().max()) if fb.numel() else 0.0
                err = float((fa - fb).abs().max()) if fb.numel() else 0.0
                if not err <= tol * max(scale, 1.0):
                    raise AssertionError(
                        f"K1 {case} {dtype} {name}: max |kernel - plain| {err:.3e} "
                        f"> {tol:g} * max(|plain|, 1) = {tol * max(scale, 1.0):.3e}")
                max_abs = max(max_abs, err)
            ok = out[-1].cpu().numpy()
            if not np.array_equal(ok, ref[-1].cpu().numpy()):
                raise AssertionError(f"K1 {case} {dtype}: ok differs")
            if not np.array_equal(ok == 0, bad):
                raise AssertionError(f"K1 {case} {dtype}: ok=0 lanes are not the indefinite ones")
            line = f"[k1] {case} {str(dtype).split('.')[-1]}: max |kernel - plain| {max_abs:.3e} (tol {tol:g} relative), ok equal, {int((ok == 0).sum())} lanes ok=0"
            if case == "well_conditioned":
                k_ms = cuda_ms(lambda: pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg))
                p_ms = cuda_ms(lambda: pk.backward_pass_multiref_reference(kin[:7], kin[7], kin[8], reg))
                line += f"; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms (median of 10)"
                if dtype == torch.float32:
                    record = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms)
            log(line)
    return record


# ---------------------------------------------------------------------------
# phase 4: the slice end to end
# ---------------------------------------------------------------------------


class Sections:
    """``section(name)`` context manager for make_batched_solve_sl: host
    wall time and device time (CUDA events, no synchronisation) per phase."""

    def __init__(self):
        self.host = collections.Counter()
        self.events = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        yield
        b.record()
        self.host[name] += time.perf_counter() - t0
        self.events[name].append((a, b))

    def device_ms(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self.events.items()}


def bench_inputs(B, T, dtype, device):
    """bench.py's protocol: x0 = 0.05 N(0,1) spliced into zero states,
    controls 0.05 (bench.py:281-284), from a numpy seed."""
    rng = np.random.default_rng(SEED)
    xs = np.zeros((B, T, 4))
    xs[:, 0] = 0.05 * rng.standard_normal((B, 4))
    us = np.full((B, T - 1, 1), 0.05)
    ws = np.zeros((B, T, 0))
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in (xs, us, ws)]


def recomputed_solved_fraction(spec, sol, ws, tol):
    from torch.func import vmap

    from iterativelqr_tpu_torch.ops.derivatives import constraint_values

    c = vmap(lambda x, u, w: constraint_values(spec, x, u, w))(sol.xs, sol.us, ws)
    ineq = torch.as_tensor(spec.ineq_mask, device=c.device)
    cmask = torch.as_tensor(spec.c_mask, device=c.device)
    v = torch.where(ineq, torch.clamp(c, min=0.0), torch.abs(c))
    v = torch.where(cmask, v, torch.zeros_like(v)).amax(dim=(1, 2))
    return float((v <= tol).to(torch.float32).mean())


def run_preset(P, pk, name, kw):
    from iterativelqr_tpu_torch.core.solve_sl import make_batched_solve_sl
    from iterativelqr_tpu_torch.models import acrobot

    dtype, device = torch.float32, torch.device("cuda")
    spec = P.build_spec(*acrobot.problem(T_MAIN)[:3])
    opts = P.Options(**kw)
    xs, us, ws = bench_inputs(B_MAIN, T_MAIN, dtype, device)

    # warm-up: the same program, cut to three iterations
    warm = P.make_batched_solve_fn(
        spec, dataclasses.replace(opts, max_total_iterations=3),
        device=device, dtype=dtype)
    warm(xs, us, ws)
    torch.cuda.synchronize()

    # the main path, counted: the user entry point, no instrumentation
    solve = P.make_batched_solve_fn(spec, opts, device=device, dtype=dtype)
    pk.RICCATI_LAUNCHES.reset()
    t0 = time.perf_counter()
    sol = solve(xs, us, ws)
    stats = P.batch_stats(sol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pk.RICCATI_LAUNCHES.launches

    # the per-iteration split: the same solve with the per-phase timer,
    # cut to its first SPLIT_ITERATIONS iterations (every lane still live)
    sections = Sections()
    timed = make_batched_solve_sl(
        spec, dataclasses.replace(opts, max_total_iterations=SPLIT_ITERATIONS),
        device=device, dtype=dtype, section=sections)
    sol2 = timed(xs, us, ws)
    torch.cuda.synchronize()
    dev_ms = sections.device_ms()
    split_trips = int(sol2.iterations.max())

    # integrity: shapes, finiteness, solved fraction recomputed fresh
    if tuple(sol.xs.shape) != (B_MAIN, T_MAIN, 4) or tuple(sol.us.shape) != (B_MAIN, T_MAIN - 1, 1):
        raise AssertionError(f"{name}: bad shapes {tuple(sol.xs.shape)} {tuple(sol.us.shape)}")
    for f in ("xs", "us", "K", "k", "objective", "max_violation"):
        if not bool(torch.isfinite(getattr(sol, f)).all()):
            raise AssertionError(f"{name}: non-finite {f}")
    frac = float(stats.solved_fraction)
    frac_true = recomputed_solved_fraction(spec, sol, ws, opts.constraint_tolerance)
    if abs(frac_true - frac) > 0.01:
        raise AssertionError(f"{name}: batch_stats solved {frac} vs recomputed {frac_true}")
    if frac_true < 0.99:
        raise AssertionError(f"{name}: recomputed solved fraction {frac_true} < 0.99")
    if launches <= 0:
        raise AssertionError(f"{name}: K1 was not launched on the main path")

    its = sol.iterations
    trips = int(its.max())                  # loop iterations of the batch
    na = opts.num_step_sizes
    tail_gates = trips if na > 8 else 0
    syncs = (trips + 1) + launches + tail_gates
    der_host = sections.host["derive_backward"] / split_trips * 1e3
    ls_host = sections.host["line_search"] / split_trips * 1e3
    der_dev = dev_ms["derive_backward"] / split_trips
    ls_dev = dev_ms["line_search"] / split_trips
    log(f"[slice] {name}: B={B_MAIN} T={T_MAIN} f32 candidates={na}")
    log(f"[slice] {name}: solved_fraction batch_stats {frac:.4f} recomputed {frac_true:.4f}; "
        f"iterations mean {float(its.float().mean()):.2f} max {trips}; "
        f"mean objective {float(stats.mean_objective):.4f}; max violation {float(stats.max_violation):.3e}")
    log(f"[slice] {name}: wall {wall:.3f} s after a warm-up ({B_MAIN * frac / wall:.1f} solved/s); "
        f"K1 launches {launches}; host syncs {syncs} "
        f"(loop tests {trips + 1}, reg-retry tests {launches}, tail gates {tail_gates})")
    log(f"[slice] {name}: per iteration (first {split_trips}) derive+backward {der_host:.2f} ms host / {der_dev:.2f} ms device-events, "
        f"line search {ls_host:.2f} ms host / {ls_dev:.2f} ms device-events")
    return launches


# ---------------------------------------------------------------------------
# phase 5: reference checks on small inputs
# ---------------------------------------------------------------------------


def check_card_vs_cpu(P):
    """The slice on the card (CUDA kernel) against the port's plain CPU path,
    acrobot T=9, B=4, f64: equal iterates, trajectories within 1e-8."""
    from iterativelqr_tpu_torch.models import acrobot

    T, B = 9, 4
    spec = P.build_spec(*acrobot.problem(T)[:3])
    opts = P.Options(record_traces=False, max_iterations=12, max_dual_updates=3)
    sols = {}
    for dev in ("cpu", "cuda"):
        xs, us, ws = bench_inputs(B, T, torch.float64, dev)
        sols[dev] = P.make_batched_solve_fn(spec, opts, device=dev, dtype=torch.float64)(xs, us, ws)
    a, b = sols["cpu"], sols["cuda"]
    for f in ("iterations", "al_iterations", "status"):
        if not torch.equal(getattr(a, f), getattr(b, f).cpu()):
            raise AssertionError(f"card vs cpu: {f} differ")
    for f in ("xs", "us", "objective", "max_violation"):
        torch.testing.assert_close(getattr(b, f).cpu(), getattr(a, f), rtol=1e-8, atol=1e-8)
    log(f"[check] card vs plain CPU path (T={T}, B={B}, f64): iterations {a.iterations.tolist()} equal; "
        f"max |dxs| {float((a.xs - b.xs.cpu()).abs().max()):.3e}")


def check_golden(P):
    """The committed golden T=101 solution (reference-exact AL schedule,
    initial states rolled out from us0), solved on the card in f64."""
    from iterativelqr_tpu_torch.models import acrobot

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures", "golden_acrobot_T101.npz")
    data = np.load(path)
    T = data["xs"].shape[0]
    dev, dtype = torch.device("cuda"), torch.float64
    dyn, cost, con, x1, _ = acrobot.problem(T)
    spec = P.build_spec(dyn, cost, con)
    us = torch.as_tensor(data["us0"], dtype=dtype, device=dev)
    x = x1.to(dtype=dtype, device=dev)
    xs = [x]
    for t in range(T - 1):
        x = dyn[t](x, us[t])
        xs.append(x)
    xs = torch.stack(xs)[None]
    ws = torch.zeros((1, T, 0), dtype=dtype, device=dev)
    opts = P.Options(record_traces=False, adaptive_penalty=False)
    sol = P.make_batched_solve_fn(spec, opts, device=dev, dtype=dtype)(xs, us[None], ws)
    viol = float(sol.max_violation[0])
    dx = float(np.abs(sol.xs[0].cpu().numpy() - data["xs"]).max())
    du = float(np.abs(sol.us[0].cpu().numpy() - data["us"]).max())
    log(f"[check] golden acrobot T={T} (f64 on the card): violation {viol:.3e}, "
        f"objective {float(sol.objective[0]):.4f} (golden {float(data['objective']):.4f}), "
        f"max |dxs| {dx:.3e}, max |dus| {du:.3e}, iterations {int(sol.iterations[0])}")
    # tests/test_golden.py's gates for this fixture
    if not (viol <= 5e-3 and dx <= 1e-2 and du <= 5e-2):
        raise AssertionError("golden acrobot T=101: outside tests/test_golden.py's gates")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is false")
    import iterativelqr_tpu_torch as P
    from iterativelqr_tpu_torch import _build
    from iterativelqr_tpu_torch.ops import packed_backward as pk

    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[id] {smi}; torch {torch.__version__}; CUDA {torch.version.cuda}; nvcc: {nvcc}; "
        f"device count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({_build.library_path().name})")

    k1 = check_k1(pk)

    launches = {}
    for name, kw in (("tuned", TUNED), ("parity", PARITY)):
        launches[name] = run_preset(P, pk, name, kw)

    check_card_vs_cpu(P)
    check_golden(P)

    print(json.dumps({"kernels": [{
        "name": "riccati_backward",
        "route": "cuda",
        "source": "iterativelqr_tpu_torch/csrc/riccati_backward.cu",
        "replaces": "iterativelqr_tpu/ops/packed_backward.py:509",
        "launches": launches["tuned"] + launches["parity"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
