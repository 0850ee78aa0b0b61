"""Acrobot swing-up (examples/acrobot.py on the port; reference:
examples/acrobot.jl).

Swing the underactuated double pendulum from hanging (0, 0, 0, 0) to
upright (pi, 0, 0, 0) with a terminal equality constraint.
Run: python -m iterativelqr_tpu_torch.examples.acrobot [--horizon 51] [--device cuda]
"""

import argparse

import numpy as np
import torch

from iterativelqr_tpu_torch import Options, Solver, rollout
from iterativelqr_tpu_torch.models import acrobot


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=51)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    T = args.horizon
    dynamics, objective, constraints, x1, xT = acrobot.problem(T)
    solver = Solver(dynamics, objective, constraints, options=Options(verbose=True),
                    device=args.device)

    us = [torch.full((1,), 0.05, dtype=torch.float64, device=args.device) for _ in range(T - 1)]
    solver.initialize_states(rollout(dynamics, x1.to(args.device), us))
    solver.initialize_controls(us)

    sol = solver.solve()
    xs, _ = solver.get_trajectory()
    x_last = xs[-1].cpu().numpy()
    print("terminal state:", x_last, " goal:", xT.numpy())
    print("terminal error:", float(np.abs(x_last - xT.numpy()).max()))
    return sol


if __name__ == "__main__":
    main()
