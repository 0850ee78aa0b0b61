#!/usr/bin/env python3
"""Times the batch-sharded solve (iterativelqr_tpu_torch/parallel/shard.py)
across the cards of one host, against the same work on one card.

    python3 chip_shard_times.py [--out FILE]

Needs two or more CUDA cards and uses every visible one (n of them).  Both
routes solve acrobot in f32 on bench.py's inputs (chip_smoke.py's helpers,
loaded from beside this script):

* SL route, the tuned preset with the rollout kernels, T=101, B=4096: the
  whole batch on cuda:0 against make_sharded_solve_fn over the n cards
  (each card's trips queued in turns on one host thread).
* vmap route, Options() with traces (the literal default's route), T=51,
  64 lanes a card, cut to VMAP_ITERATIONS iterations: make_sharded_solve_fn
  over the n cards (the shards one after the other) against the whole
  batch on cuda:0.

The sharded SL solve is held bitwise (iterations, xs, us) against one
card's lanes; on the vmap route the whole batch on one card only reports
whether its lanes agree with the shards' (its batched library calls may
round otherwise at another batch size).  A wall is the median of REPEATS solves after one
warm-up solve of the same solver; the variants of a route take turns
within each repeat.  Prints one line a measurement and the nvidia-smi
line of every card, and writes the numbers to ``--out`` as JSON where
given.  Exits 1 without two cards.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
REPEATS = 3
VMAP_T, VMAP_LANES, VMAP_ITERATIONS = 51, 64, 10


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wall(fn):
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    out = fn()
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    return out, time.perf_counter() - t0


def _same_lanes(label, sol, ref, exact):
    """Whether ``sol``'s lanes equal ``ref``'s bitwise; raises where the
    variant must (``exact``)."""
    same = all(torch.equal(getattr(sol, f).to(getattr(ref, f).device), getattr(ref, f))
               for f in ("iterations", "xs", "us"))
    if exact and not same:
        raise AssertionError(f"{label}: its lanes differ from the first variant's")
    return same


def time_route(label, variants, inputs):
    """``variants``: [(name, solve, exact)], each ``solve(xs, us, ws) ->
    Solution``, ``exact`` where its lanes must equal the first variant's
    bitwise (the same shard shapes); warms each up once, then times
    REPEATS rounds in turns.  Returns {name: {"walls": [...], "bitwise":
    bool}}."""
    first, out = None, {}
    for name, solve, exact in variants:
        sol = solve(*inputs)
        first = sol if first is None else first
        out[name] = {"walls": [], "bitwise": _same_lanes(f"{label}/{name}", sol, first, exact)}
    for _ in range(REPEATS):
        for name, solve, exact in variants:
            sol, w = _wall(lambda: solve(*inputs))
            _same_lanes(f"{label}/{name}", sol, first, exact)
            out[name]["walls"].append(w)
    base = statistics.median(out[variants[0][0]]["walls"])
    for name, rec in out.items():
        med = statistics.median(rec["walls"])
        print(f"[shard times] {label}/{name}: median {med:.3f} s over {REPEATS} "
              f"({', '.join(f'{w:.3f}' for w in rec['walls'])}); {base / med:.2f} x the "
              f"{variants[0][0]} variant's speed; lanes bitwise equal to it: "
              f"{rec['bitwise']}", flush=True)
    return out


def sl_variants(P, cs, devices):
    from iterativelqr_tpu_torch.models import acrobot
    from iterativelqr_tpu_torch.parallel import default_mesh, make_sharded_solve_fn

    spec = P.build_spec(*acrobot.problem(cs.T_MAIN)[:3])
    opts = P.Options(**cs.TUNED, forward_kernel="pallas")
    inputs = cs.bench_inputs(cs.B_MAIN, cs.T_MAIN, torch.float32, devices[0])
    sharded = make_sharded_solve_fn(spec, opts, mesh=default_mesh(devices), with_stats=False)
    one = make_sharded_solve_fn(spec, opts, mesh=default_mesh(devices[:1]), with_stats=False)
    return [("one card", one, True), (f"{len(devices)} cards", sharded, True)], inputs


def vmap_variants(P, cs, devices):
    from iterativelqr_tpu_torch.models import acrobot
    from iterativelqr_tpu_torch.parallel import default_mesh, make_sharded_solve_fn

    spec = P.build_spec(*acrobot.problem(VMAP_T)[:3])
    opts = P.Options(verbose=False, max_total_iterations=VMAP_ITERATIONS)
    n = len(devices)
    inputs = cs.bench_inputs(VMAP_LANES * n, VMAP_T, torch.float32, devices[0])
    sharded = make_sharded_solve_fn(spec, opts, mesh=default_mesh(devices), with_stats=False)
    one = P.make_batched_solve_fn(spec, opts, device=devices[0], dtype=torch.float32)
    return [(f"{n} cards", sharded, True), ("one card", one, False)], inputs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_shard_times.py needs two or more CUDA cards", file=sys.stderr)
        return 1
    import iterativelqr_tpu_torch as P
    from iterativelqr_tpu_torch import _build

    cs = _smoke()
    t0 = time.perf_counter()
    _build.build()
    print(f"[shard times] kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True, timeout=60).stdout.strip().splitlines()
    for line in cards:
        print(f"[shard times] card: {line}", flush=True)
    record = {"cards": cards, "repeats": REPEATS}
    variants, inputs = sl_variants(P, cs, devices)
    record["sl_tuned_T101_B4096"] = time_route("SL tuned T=101 B=4096", variants, inputs)
    variants, inputs = vmap_variants(P, cs, devices)
    record[f"vmap_T{VMAP_T}_B{VMAP_LANES * len(devices)}_it{VMAP_ITERATIONS}"] = time_route(
        f"vmap Options() T={VMAP_T} B={VMAP_LANES * len(devices)}", variants, inputs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
