"""Unicycle car with obstacle avoidance (examples/car.py on the port;
reference: examples/car.jl).

Drive to (1, 1, 0) around a circular obstacle at (0.5, 0.5) under control
box bounds: inequality and terminal equality constraints.
Run: python -m iterativelqr_tpu_torch.examples.car [--horizon 51] [--device cuda]
"""

import argparse

import numpy as np

from iterativelqr_tpu_torch import Options, Solver, rollout
from iterativelqr_tpu_torch.models import car


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=51)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    T = args.horizon
    dynamics, objective, constraints, x1, xT = car.problem(T)
    solver = Solver(dynamics, objective, constraints, options=Options(verbose=True),
                    device=args.device)

    us = [u.to(args.device) for u in car.initial_controls(T)]
    solver.initialize_states(rollout(dynamics, x1.to(args.device), us))
    solver.initialize_controls(us)

    sol = solver.solve()
    xs, us = solver.get_trajectory()
    xs = np.stack([x.cpu().numpy() for x in xs])
    dist = np.hypot(xs[:, 0] - 0.5, xs[:, 1] - 0.5)
    print("terminal state:", xs[-1], " goal:", xT.numpy())
    print("closest obstacle approach:", dist.min(), "(radius 0.1)")
    print("max violation:", float(sol.max_violation))
    return sol


if __name__ == "__main__":
    main()
