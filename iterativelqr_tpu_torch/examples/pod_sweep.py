"""Pod-scale scenario sweep: 65,536 car + acrobot instances over a
batch-sharded mesh (examples/pod_sweep.py on the port).

Every rank of a process group runs this same script (e.g. under
``torchrun``, which sets ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``); it joins the group with ``distributed_initialize``, builds
its mesh over its own card and feeds its share of the global batch.  With
no ``WORLD_SIZE`` in the environment it runs as one process over every
visible card.  The sweep solves two problem families (car obstacle and
acrobot swing-up) as two sharded batched solves, with statistics reduced
across the mesh.

Run: python -m iterativelqr_tpu_torch.examples.pod_sweep [--total 65536]
    [--horizon 51] [--quick] [--device cuda]
"""

import argparse
import os
import time

import numpy as np
import torch

from iterativelqr_tpu_torch import Options, build_spec
from iterativelqr_tpu_torch.models import acrobot, car
from iterativelqr_tpu_torch.ops.rollout import open_loop_rollout
from iterativelqr_tpu_torch.parallel import (default_mesh, distributed_initialize,
                                             global_batch_from_local, make_sharded_solve_fn)


def families(T):
    """(name, spec, x0 noise scale, controls [T-1, nu]) of the two
    families, as the JAX example samples them."""
    spec_a = build_spec(*acrobot.problem(T)[:3])
    spec_c = build_spec(*car.problem(T)[:3])
    return (("acrobot", spec_a, 0.05, np.full((T - 1, spec_a.nu), 0.05)),
            ("car", spec_c, 0.05, np.tile([1.0e-2, 1.0e-3], (T - 1, 1))))


def sweep(name, spec, scale, us0, T, total, mesh, opts, dtype=torch.float32):
    """One family's sharded solve of ``total`` instances; returns (the
    global Solution, its stats, wall s)."""
    local = total // mesh.world_size
    device = mesh.devices[0]
    # this rank's rows of the global batch: x0 = scale N(0,1) from a seed
    # a rank
    rng = np.random.default_rng(7 + mesh.rank)
    x0 = torch.as_tensor(scale * rng.standard_normal((local, spec.nx)), dtype=dtype,
                         device=device)
    us = torch.as_tensor(us0, dtype=dtype, device=device).expand(local, T - 1, spec.nu)
    ws = torch.zeros((local, T, max(spec.npar, 0)), dtype=dtype, device=device)
    # dynamically consistent warm start (open-loop rollout), as the
    # reference examples initialize
    xs = open_loop_rollout(spec, x0, us, ws)
    solve = make_sharded_solve_fn(spec, opts, mesh=mesh, dtype=dtype)
    args = global_batch_from_local(mesh, "batch", xs, us.contiguous(), ws)
    t0 = time.perf_counter()
    sol, stats = solve(*args)
    solved = float(stats.solved_fraction)
    dt = time.perf_counter() - t0
    if mesh.rank == 0:
        print(f"{name}: {total} instances in {dt:.2f}s ({total / dt:.0f} solves/s, "
              f"{total / dt / mesh.size:.0f} /s/device), solved {solved:.3f}")
    return sol, stats, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--total", type=int, default=65536)
    ap.add_argument("--horizon", type=int, default=51)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.quick:
        args.total = 256

    # torchrun and other cluster runners set WORLD_SIZE; without it this is
    # the single-process mode
    if "WORLD_SIZE" in os.environ:
        distributed_initialize(init_method="env://")
    else:
        print("single-process mode (no process group: WORLD_SIZE is not set)")
    mesh = default_mesh(None if args.device == "cuda" else [args.device])
    T = args.horizon
    # "auto" takes the rollout kernels (K3/K4) on the card; the JAX example
    # keeps "scan", an XLA scan on a TPU, which here would be the Python
    # loop rollouts (480-491 ms a trip)
    opts = Options(verbose=False, record_traces=False, forward_kernel="auto")
    return {name: sweep(name, spec, scale, us0, T, args.total // 2, mesh, opts)
            for name, spec, scale, us0 in families(T)}


if __name__ == "__main__":
    main()
