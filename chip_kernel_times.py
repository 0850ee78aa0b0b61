#!/usr/bin/env python3
"""Times the port's hand-written kernels on one CUDA card, at the shapes of
chip_smoke.py's phases 3, 3b and 3c (B=4096; K1, K5, K6 acrobot (4, 1)
T=101, K1 also at car's (3, 2) and particle's (2, 1), K6 (3, 2); K2, and
K5, K6 at (12, 4), quadrotor T=41; K3 and K4 acrobot T=101, car T=51,
quadrotor T=41; past n + m = 32, K2 at chip_smoke.py's TALL_GRID and K5, K6a,
K6b at (36, 12), f32, T=41).  A case that a checkout cannot run (an instantiation it
lacks raises NotImplementedError) is left out of that checkout's results.
Each case's outputs on its inputs are hashed (SHA-256 of their bytes), and
cases that every tree ran are reported bitwise equal or not across the
trees.

    python3 chip_kernel_times.py [--repeats 3] [--tree DIR ...] [--only TEXT] [--out FILE]

Each ``--tree`` is a checkout of this repository (default: this one),
timed in a child process of its own that builds that checkout's kernels
and imports its package; trees run in the order given, so naming two
checkouts as ``A B B A`` compares them in turns on one card.  ``--only``
keeps the cases whose name contains TEXT (repeatable).  A repeat is
the median of 20 launches after 3 warm-ups (CUDA events around each
launch); every case is timed once per repeat, repeats outermost.  Prints
one line per tree and case (the repeats, their median and spread, the
bound and its share) and each tree's ptxas report, and writes every
number to ``--out`` as JSON where given.  The input constructors and bounds are
chip_smoke.py's (loaded from beside this script).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _holds(pk, n, m, dtype):
    """Does this checkout's rule hold (n, m, dtype)?"""
    try:
        pk.riccati_plan(n, m, dtype)
    except NotImplementedError:
        return False
    return True


def _cases(cs, pk, pb, fk, torch):
    """(name, launch, bound ms or None) of every timed case."""
    B = cs.B_MAIN
    cases = []
    for dtype, dn in ((torch.float32, "f32"), (torch.float64, "f64")):
        # B=4097: a ragged edge whose runs are not 16-byte aligned
        for label, n, m, T, make, nb in (("K1", 4, 1, cs.T_MAIN, cs.random_stacks, B),
                                         ("K1", 4, 1, cs.T_MAIN, cs.random_stacks, B + 1),
                                         ("K1", 3, 2, cs.T_MAIN, cs.wide_stacks, B),
                                         ("K1", 2, 1, cs.T_MAIN, cs.random_stacks, B),
                                         ("K2", 12, 4, cs.T_QUAD, cs.wide_stacks, B),
                                         ("K2", 12, 4, cs.T_QUAD, cs.wide_stacks, B + 1)):
            if nb != B and dtype == torch.float64:
                continue
            Tm1 = T - 1
            dev = [torch.as_tensor(a, dtype=dtype, device="cuda")
                   for a in make(cs.SEED, nb, Tm1, n, m)]
            kin = [a.contiguous() for a in pk.prepare_stacks(
                *dev, torch.ones((Tm1, m), dtype=torch.bool))]
            reg = torch.zeros(nb, dtype=dtype, device="cuda")
            run = (lambda kin=kin, reg=reg:
                   pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg))
            out = run()
            nbytes = sum(a.numel() * a.element_size() for a in (*kin, reg, *out))
            cases.append((f"{label} ({n},{m}) T={T} {dn}" + ("" if nb == B else f" B={nb}"), run,
                          cs.bound_ms(nbytes, cs.riccati_ops(n, m) * Tm1 * nb)[0]))
        for label in ("K5", "K6a", "K6b"):
            for n, m, T in ((4, 1, cs.T_MAIN), (3, 2, cs.T_MAIN), (12, 4, cs.T_QUAD)):
                if (label == "K5" and m == 2) or (dtype == torch.float64 and m == 2):
                    continue
                st, um, reg, _ = cs.masked_case(cs.SEED, B, T - 1, n, m,
                                                "well_conditioned", dtype)
                kern, _, _, kin = cs.packed_masked_runs(pk, pb, label, st, um, reg)
                try:
                    out = kern()
                except NotImplementedError:
                    continue
                nbytes = sum(a.numel() * a.element_size() for a in (*kin, *out))
                ops = cs.riccati_ops(n, m) * (T - 1) * B
                cases.append((f"{label} ({n},{m}) T={T} {dn}", kern,
                              cs.bound_ms(nbytes, ops)[0]))
        for name, T in (("acrobot", cs.T_MAIN), ("car", cs.T_CAR), ("quadrotor", cs.T_QUAD)):
            r, live, alpha = cs.rollout_case(fk, name, T, B, dtype, cs.SEED)
            size = torch.finfo(dtype).bits // 8
            runs = [("K3 head j0=0 nb=8", lambda r=r, live=live: fk.score_rollout(r, 0, 8, *live), 8),
                    ("K4 per-lane alpha",
                     lambda r=r, live=live, alpha=alpha: fk.winner_reroll(r, alpha, *live), None)]
            if dtype == torch.float32:
                runs.insert(1, ("K3 tail j0=8 nb=9",
                                lambda r=r, live=live: fk.score_rollout(r, 8, 9, *live), 9))
            for what, run, nb in runs:
                nbytes = cs.rollout_bytes(r.spec, B, size, nb)
                ops = cs.OPS_PER_STEP[name] * (T - 1) * B * (nb or 1)
                cases.append((f"{what} {name} T={T} {dn}", run, cs.bound_ms(nbytes, ops)[0]))
    # past n + m = 32 (the tall template): K2 at chip_smoke.py's TALL_GRID and
    # K5, K6a, K6b at the team's (36, 12), f32, B=4096, T=TEAM_T, on stacks
    # drawn on the card (chip_smoke.py::device_stacks)
    T = cs.TEAM_T
    for n, m in cs.TALL_GRID:
        if not _holds(pk, n, m, torch.float32):
            continue
        kin = [a.contiguous() for a in pk.prepare_stacks(
            *(a.float() for a in cs.device_stacks(cs.SEED, B, T - 1, n, m)),
            torch.ones((T - 1, m), dtype=torch.bool))]
        reg = torch.zeros(B, dtype=torch.float32, device="cuda")
        run = lambda kin=kin, reg=reg: pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
        out = run()
        nbytes = sum(a.numel() * a.element_size() for a in (*kin, reg, *out))
        cases.append((f"K2 ({n},{m}) T={T} f32", run,
                      cs.bound_ms(nbytes, cs.riccati_ops(n, m) * (T - 1) * B)[0]))
    n, m = cs.TEAM
    st = [a.float().contiguous() for a in cs.device_stacks(cs.SEED, B, T - 1, n, m)]
    um = torch.ones((T - 1, m), dtype=torch.float32, device="cuda")
    um[:, -1] = 0.0
    reg = torch.full((B,), 0.1, dtype=torch.float32, device="cuda")
    for label in ("K5", "K6a", "K6b"):
        kern, _, _, kin = cs.packed_masked_runs(pk, pb, label, st, um, reg)
        out = kern()
        nbytes = sum(a.numel() * a.element_size() for a in (*kin, *out))
        cases.append((f"{label} ({n},{m}) T={T} f32", kern,
                      cs.bound_ms(nbytes, cs.riccati_ops(n, m) * (T - 1) * B)[0]))
    cs.device_stacks.cache_clear()
    torch.cuda.synchronize()
    return cases


def child(tree: Path, label: str, repeats: int, only):
    sys.path.insert(0, str(tree))
    import torch

    import iterativelqr_tpu_torch as P
    from iterativelqr_tpu_torch import _build
    from iterativelqr_tpu_torch.ops import packed_backward as pk
    from iterativelqr_tpu_torch.ops import pallas_backward as pb
    from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk

    if not Path(P.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {P.__file__}, not the package of {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_times.py needs a CUDA card")
    cs = _smoke()
    t0 = time.perf_counter()
    _build.load_library()
    if hasattr(pk, "build"):
        # the recursion's libraries, built at first use: all of them now
        pk.build(*cs.REGISTERED_DIMS, dtypes=cs.DTYPES)
        pk.build(*(d for d in cs.TALL_GRID if _holds(pk, *d, torch.float32)))
    build_s = time.perf_counter() - t0
    cases = [c for c in _cases(cs, pk, pb, fk, torch)
             if not only or any(o in c[0] for o in only)]
    digests = {}
    for name, run, _ in cases:
        out = run()
        h = hashlib.sha256()
        for a in (out if isinstance(out, (tuple, list)) else (out,)):
            h.update(a.detach().contiguous().cpu().numpy().tobytes())
        digests[name] = h.hexdigest()
    times = {name: [] for name, _, _ in cases}
    for _ in range(repeats):
        for name, run, _ in cases:
            times[name].append(cs.cuda_ms(run, reps=20, warmup=3))
    res = {"tree": label, "build_s": build_s, "ptxas": _build.ptxas_report(),
           "cases": {name: {"ms": times[name], "median_ms": statistics.median(times[name]),
                            "bound_ms": bound, "digest": digests[name]}
                     for name, _, bound in cases}}
    print("RESULT " + json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout of the repository (repeatable; default: this one)")
    ap.add_argument("--only", action="append", default=None,
                    help="time only the cases whose name contains this (repeatable)")
    ap.add_argument("--out", help="write every number here as JSON")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(Path(args.child).resolve(), args.label, args.repeats, args.only)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[id] {smi}", flush=True)
    results = []
    for tree in args.tree or [str(HERE)]:
        label = os.path.relpath(Path(tree).resolve(), HERE)
        only = [a for o in args.only or [] for a in ("--only", o)]
        proc = subprocess.run([sys.executable, __file__, "--child", tree, "--label", label,
                               "--repeats", str(args.repeats), *only],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"timing {tree} failed ({proc.returncode})")
        res = json.loads(next(ln for ln in proc.stdout.splitlines()
                              if ln.startswith("RESULT "))[len("RESULT "):])
        results.append(res)
        print(f"[tree] {label}: built in {res['build_s']:.1f} s", flush=True)
        for line in res["ptxas"]:
            print(f"[ptxas] {label}: {line}", flush=True)
        for name, c in res["cases"].items():
            spread = max(c["ms"]) - min(c["ms"])
            print(f"[time] {label}: {name}: median {c['median_ms']:.4f} ms "
                  f"(repeats {', '.join(f'{t:.4f}' for t in c['ms'])}; spread {spread:.4f}); "
                  f"bound {c['bound_ms']:.4f} ms, {c['bound_ms'] / c['median_ms']:.1%} of it",
                  flush=True)
    shared = set.intersection(*(set(r["cases"]) for r in results))
    for name in sorted(shared):
        same = len({r["cases"][name]["digest"] for r in results}) == 1
        print(f"[bitwise] {name}: outputs {'equal' if same else 'DIFFER'} across "
              f"{len(results)} runs", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "results": results}, indent=1))


if __name__ == "__main__":
    main()
