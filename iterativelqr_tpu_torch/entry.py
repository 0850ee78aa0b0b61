"""Entry points: the flagship solve and a multi-device dry run.

Counterpart of ``__graft_entry__.py``:

``entry``            — ``(fn, example_args)``: one full constrained AL-iLQR
                       solve of the acrobot swing-up, T=51, per instance,
                       with the default ``Options(verbose=False)``, on the
                       card unless the caller asks for the CPU.
``dryrun_multichip`` — the three batch-sharded routes over an n-entry mesh
                       (``parallel/shard.py``; entries repeat a card when
                       there are fewer cards than entries) on tiny shapes,
                       each checked.

Run both: ``python -m iterativelqr_tpu_torch.entry [--device cpu]``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _acrobot_spec(T):
    from .core.spec import build_spec
    from .models import acrobot

    dynamics, objective, constraints, x1, _ = acrobot.problem(T)
    return build_spec(dynamics, objective, constraints), x1


def acrobot_program(T, device="cuda", dtype=torch.float32):
    """``entry``'s program at horizon T: the per-instance solve with the
    default options and its arguments (x1 spliced into zero states,
    controls 0.05)."""
    from .core.options import Options
    from .core.solve import make_solve_fn

    spec, x1 = _acrobot_spec(T)
    solve = make_solve_fn(spec, Options(verbose=False), device=device)
    xs = torch.zeros((T, spec.nx), dtype=dtype, device=device)
    xs[0] = x1.to(device, dtype)
    us = torch.full((T - 1, spec.nu), 0.05, dtype=dtype, device=device)
    ws = torch.zeros((T, max(spec.npar, 0)), dtype=dtype, device=device)
    return solve, (xs, us, ws)


def entry(device="cuda"):
    """Return (fn, example_args): a constrained solve, acrobot T=51, f32."""
    return acrobot_program(51, device)


def _mesh_devices(n_devices, device):
    """n entries: distinct cards while there are enough, then repeats."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_devices
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("dryrun_multichip needs a CUDA card (or device='cpu')")
    return [torch.device("cuda", i % n_cards) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the three batch-sharded routes over an ``n_devices``-entry mesh
    on acrobot T=9, two instances an entry, f32, and check them:

    1. the vmap route (``make_sharded_solve_fn`` with
       ``batched_solver="vmap"``),
    2. the SL route (``batched_solver="sl"``, ``backward_pass="packed"``),
    3. per-device straggler compaction (``make_compacted_solve_fn`` with
       ``devices``);

    iterations equal across routes, xs within 2e-3, and the violations
    each route reports equal to those recomputed from its trajectories
    (rtol 1e-4, atol 1e-5)."""
    from .core.options import Options
    from .core.solve_compact import make_compacted_solve_fn
    from .ops import derivatives as dv
    from .parallel import default_mesh, make_sharded_solve_fn, shard_batch

    devices = _mesh_devices(n_devices, device)
    mesh = default_mesh(devices)
    T = 9
    spec, x1 = _acrobot_spec(T)
    base = dict(verbose=False, record_traces=False, max_iterations=3, max_dual_updates=2)
    B = 2 * n_devices
    dtype, home = torch.float32, devices[0]
    rng = np.random.default_rng(0)
    xs = np.zeros((B, T, spec.nx))
    xs[:, 0] = x1.numpy() + 0.01 * rng.standard_normal((B, spec.nx))
    xs, us, ws = (torch.as_tensor(a, dtype=dtype, device=home) for a in (
        xs, np.full((B, T - 1, spec.nu), 0.05), np.zeros((B, T, max(spec.npar, 0)))))

    sol, stats = make_sharded_solve_fn(spec, Options(batched_solver="vmap", **base),
                                       mesh=mesh, dtype=dtype)(
        *shard_batch(mesh, "batch", xs, us, ws))
    sl_opts = Options(batched_solver="sl", backward_pass="packed", **base)
    sol_sl, stats_sl = make_sharded_solve_fn(spec, sl_opts, mesh=mesh, dtype=dtype)(xs, us, ws)
    for name, st in (("vmap", stats), ("sl", stats_sl)):
        if not bool(torch.isfinite(st.mean_objective)):
            raise AssertionError(f"route {name}: non-finite mean objective")
    sol_nd = make_compacted_solve_fn(spec, sl_opts, chunk=2, devices=devices, device=home,
                                     dtype=dtype)(xs, us, ws)
    for name, s in (("sl", sol_sl), ("compact", sol_nd)):
        torch.testing.assert_close(s.xs, sol.xs, rtol=2e-3, atol=2e-3, msg=name)
        if not torch.equal(s.iterations, sol.iterations):
            raise AssertionError(f"route {name}: iterations {s.iterations.tolist()} against "
                                 f"the vmap route's {sol.iterations.tolist()}")

    # the violations each route reports against violations recomputed from
    # its returned trajectories with independent operations
    ineq = torch.as_tensor(spec.ineq_mask, device=home)
    cmask = torch.as_tensor(spec.c_mask, device=home)
    for name, s in (("vmap", sol), ("sl", sol_sl), ("compact", sol_nd)):
        c = dv.constraint_values(spec, s.xs, s.us, ws)
        v = torch.where(ineq, torch.clamp(c, min=0.0), torch.abs(c))
        fresh = torch.where(cmask, v, torch.zeros_like(v)).amax(dim=(1, 2))
        torch.testing.assert_close(
            fresh, s.max_violation, rtol=1e-4, atol=1e-5,
            msg=f"route {name}: reported violations disagree with violations recomputed "
                "from the returned trajectories")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry ok: violation", float(out.max_violation))
    # every visible card, as the JAX entry takes every device; two CPU entries
    n = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 2
    dryrun_multichip(n, args.device)
    print(f"dryrun_multichip ok ({n} entries)")


if __name__ == "__main__":
    main()
