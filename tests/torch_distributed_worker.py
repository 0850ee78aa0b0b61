"""One rank of a multi-process sharded solve of the port (run by
tests/test_torch_distributed.py on the CPU, and by chip_smoke.py on the
card; one invocation a process).

The rank joins the process group through ``distributed_initialize``, takes
its own rows of a global particle batch made from numpy seed 0 (x0 = 0.1
N(0,1), zero states and controls), shards them over its mesh entries with
``global_batch_from_local`` and runs ``make_sharded_solve_fn`` on each
route asked for.  It writes its view of the global Solution and stats, and
the kernel launches of its solves, to ``<outdir>/rank<r>.npz``.  The
route "horizon" runs the time-sharded Riccati recursion across the
processes instead (``make_horizon_sharded_backward`` on a "time" mesh of
the rank's entries) on the pendulum linearizations of ``HORIZON``, and
writes its global results.  Imports torch and the port only.

Usage: python torch_distributed_worker.py <init_method> <world_size> <rank>
    <outdir> <device: cpu | cuda> <backend> <T> <B> <routes: vmap,sl,horizon>

On the CPU each rank holds two mesh entries (a 2 x world entry global
mesh); on the card one, its ``default_mesh()`` card.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

ROUTES = {
    "vmap": dict(verbose=False),
    "sl": dict(verbose=False, record_traces=False, batched_solver="sl",
               backward_pass="packed"),
}


# (T, lanes) of the time-sharded recursion's cases: padded with identity
# elements past the terminal one, and a rank with no stage step at all
HORIZON = ((13, 3), (3, 2))
HORIZON_NAMES = ("K", "k", "Qx", "Qu", "p", "ok")


def horizon_case(P, T, lanes, device):
    """The derivative stacks, control mask and per-lane regularization of
    a pendulum linearization in f64 for ``lanes`` lanes: controls 0.01 +
    0.1 N(0,1) (numpy seed 1) rolled out from the model's x1, reg 1e-3 *
    lane."""
    from iterativelqr_tpu_torch.models import pendulum
    from iterativelqr_tpu_torch.ops import derivatives as dv
    from iterativelqr_tpu_torch.ops.rollout import open_loop_rollout

    dyn, cost, con, x1, _ = pendulum.problem(T, device=device)
    spec = P.build_spec(dyn, cost, con)
    rng = np.random.default_rng(1)
    f64 = dict(dtype=torch.float64, device=device)
    us = torch.as_tensor(0.01 + 0.1 * rng.standard_normal((lanes, T - 1, spec.nu)), **f64)
    ws = torch.zeros((lanes, T, 0), **f64)
    xs = torch.stack([open_loop_rollout(spec, x1, us[b], ws[b]) for b in range(lanes)])
    stacks = (*dv.dynamics_jacobians(spec, xs, us, ws), *dv.cost_gradients(spec, xs, us, ws),
              *dv.cost_hessians(spec, xs, us, ws))
    reg = 1e-3 * torch.arange(lanes, **f64)
    return stacks, torch.as_tensor(spec.u_mask, device=device), reg


def global_batch(spec, T, B):
    rng = np.random.default_rng(0)
    xs = np.zeros((B, T, spec.nx))
    xs[:, 0] = 0.1 * rng.standard_normal((B, spec.nx))
    return xs, np.zeros((B, T - 1, spec.nu)), np.zeros((B, T, 0))


def main():
    init_method, world, rank, outdir, device, backend = sys.argv[1:7]
    world, rank = int(world), int(rank)
    T, B = int(sys.argv[7]), int(sys.argv[8])
    routes = sys.argv[9].split(",")

    import iterativelqr_tpu_torch as P
    from iterativelqr_tpu_torch.models import particle
    from iterativelqr_tpu_torch.ops import packed_backward as pk
    from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk
    from iterativelqr_tpu_torch.parallel import (default_mesh, distributed_initialize,
                                                 global_batch_from_local,
                                                 make_sharded_solve_fn)

    distributed_initialize(backend=backend, init_method=init_method,
                           world_size=world, rank=rank)
    torch.set_num_threads(1)
    dtype = torch.float64 if device == "cpu" else torch.float32
    mesh = default_mesh([torch.device("cpu")] * 2 if device == "cpu" else None)
    spec = P.build_spec(*particle.problem(T, device=device)[:3])
    rows = B // world
    local = [torch.as_tensor(a[rank * rows:(rank + 1) * rows], dtype=dtype)
             for a in global_batch(spec, T, B)]
    out = dict(world_size=world, mesh_size=mesh.size)
    if "horizon" in routes:
        from iterativelqr_tpu_torch.parallel import make_horizon_sharded_backward

        tmesh = default_mesh([torch.device("cpu")] * 2 if device == "cpu" else None, "time")
        backward = make_horizon_sharded_backward(tmesh, "time")
        out["horizon_mesh_size"] = tmesh.size
        for T_h, lanes in HORIZON:
            stacks, um, reg = horizon_case(P, T_h, lanes, tmesh.devices[0])
            res = backward(*stacks, um, reg)
            for name, v in zip(HORIZON_NAMES, res):
                out[f"horizon_T{T_h}_{name}"] = v.cpu().numpy()
    for route in (r for r in routes if r != "horizon"):
        # on the card the SL route takes the rollout kernels
        opts = P.Options(**ROUTES[route], **({"forward_kernel": "pallas"}
                                              if device != "cpu" and route == "sl" else {}))
        solve = make_sharded_solve_fn(spec, opts, mesh=mesh, dtype=dtype)
        counters = (pk.RICCATI_LAUNCHES, fk.SCORE_LAUNCHES, fk.REROLL_LAUNCHES)
        for c in counters:
            c.reset()
        sol, stats = solve(*global_batch_from_local(mesh, "batch", *local))
        out[f"{route}_launches"] = [c.launches for c in counters]
        for f in ("xs", "us", "iterations", "max_violation", "objective"):
            out[f"{route}_{f}"] = getattr(sol, f).cpu().numpy()
        for f, v in stats._asdict().items():
            out[f"{route}_stats_{f}"] = v.cpu().numpy()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
