"""Batched + sharded solve sweep (examples/batched_sweep.py on the port).

Solves a batch of acrobot swing-ups from perturbed initial conditions,
sharded over every visible card (``--device cpu``: one CPU entry).

Run: python -m iterativelqr_tpu_torch.examples.batched_sweep [--batch 512]
    [--horizon 51] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from iterativelqr_tpu_torch import Options, build_spec
from iterativelqr_tpu_torch.models import acrobot
from iterativelqr_tpu_torch.ops.rollout import open_loop_rollout
from iterativelqr_tpu_torch.parallel import default_mesh, make_sharded_solve_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=51)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    T, B = args.horizon, args.batch

    mesh = default_mesh(None if args.device == "cuda" else [args.device])
    device = mesh.devices[0]
    print(f"{len(mesh.devices)} {device.type} device(s); batch {B}")

    spec = build_spec(*acrobot.problem(T)[:3])
    # "auto": the rollout kernels on the card (pod_sweep.py says why)
    solve = make_sharded_solve_fn(
        spec, Options(verbose=False, record_traces=False, forward_kernel="auto"), mesh=mesh)

    dtype = torch.float32
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(0.05 * rng.standard_normal((B, spec.nx)), dtype=dtype, device=device)
    us = torch.full((B, T - 1, spec.nu), 0.05, dtype=dtype, device=device)
    ws = torch.zeros((B, T, max(spec.npar, 0)), dtype=dtype, device=device)
    xs = open_loop_rollout(spec, x0, us, ws)

    t0 = time.perf_counter()
    sol, stats = solve(xs, us, ws)
    float(stats.solved_fraction)
    print(f"first solve: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    sol, stats = solve(xs, us, ws)
    solved = float(stats.solved_fraction)
    dt = time.perf_counter() - t0
    print(f"steady state: {dt:.3f}s -> {B / dt:.0f} solves/s")
    print(f"solved fraction: {solved:.3f}")
    print(f"mean iterations: {float(stats.mean_iterations):.1f}")
    return sol, stats


if __name__ == "__main__":
    main()
