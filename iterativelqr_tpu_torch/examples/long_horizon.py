"""Long-horizon solve with the Riccati recursion time-sharded over a mesh
(examples/long_horizon.py on the port).

The public entry for horizons whose derivative stacks outgrow one device
(``parallel.make_long_horizon_solve_fn``): the recursion's time axis splits
into one chunk a card, and into MIN_CHUNKS chunks over the cards in turn
where there are fewer cards (four chunks on a one-card machine).

Run: python -m iterativelqr_tpu_torch.examples.long_horizon [--horizon 1025]
    [--device cuda]
"""

import argparse
import time

import torch

from iterativelqr_tpu_torch import Options, build_spec
from iterativelqr_tpu_torch.models import pendulum
from iterativelqr_tpu_torch.parallel import default_mesh, make_long_horizon_solve_fn

MIN_CHUNKS = 4


def main(argv=None):
    ap = argparse.ArgumentParser()
    # long horizon: the [T, nx*nx] derivative stacks are split over time
    ap.add_argument("--horizon", type=int, default=1025)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    T = args.horizon
    device = torch.device(args.device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    entries = ([torch.device("cuda", i % n_cards) for i in range(max(n_cards, MIN_CHUNKS))]
               if n_cards else [device] * MIN_CHUNKS)
    mesh = default_mesh(entries, "time")
    print(f"{len(set(entries))} {device.type} device(s), {len(entries)} chunks; horizon T={T}")

    dynamics, objective, constraints, x1, xT = pendulum.problem(T, device=device)
    spec = build_spec(dynamics, objective, constraints)
    solve = make_long_horizon_solve_fn(
        spec, Options(verbose=False, record_traces=False, scan_unroll=1), mesh=mesh,
        device=device)

    xs = torch.zeros((T, spec.nx), dtype=torch.float64, device=device)
    xs[0] = x1
    us = torch.full((T - 1, spec.nu), 0.01, dtype=torch.float64, device=device)
    ws = torch.zeros((T, max(spec.npar, 0)), dtype=torch.float64, device=device)

    t0 = time.perf_counter()
    sol = solve(xs, us, ws)
    objective = float(sol.objective)
    wall = time.perf_counter() - t0
    print(f"objective:     {objective:.6f}")
    print(f"max violation: {float(sol.max_violation):.2e}")
    print(f"iterations:    {int(sol.iterations)}")
    print(f"wall:          {wall:.1f}s")
    if not torch.isfinite(sol.objective):
        raise RuntimeError("the long-horizon solve returned a non-finite objective")
    return sol, wall


if __name__ == "__main__":
    main()
