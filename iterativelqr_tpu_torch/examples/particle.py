"""Particle double-integrator quickstart (examples/particle.py on the
port; reference: examples/particle.jl).

Move a 2-state particle to x_goal = (1, 0) in T=11 steps under a terminal
equality constraint.
Run: python -m iterativelqr_tpu_torch.examples.particle [--device cuda]
"""

import argparse

import torch

from iterativelqr_tpu_torch import Options, Solver, rollout
from iterativelqr_tpu_torch.models import particle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    T = 11
    dynamics, objective, constraints, x1, xT = particle.problem(T, device=args.device)
    solver = Solver(dynamics, objective, constraints, options=Options(verbose=True),
                    device=args.device)

    # initialize with zero actions rolled out open loop
    # (reference: examples/particle.jl:40-47)
    us = [torch.zeros(1, dtype=torch.float64, device=args.device) for _ in range(T - 1)]
    solver.initialize_states(rollout(dynamics, x1, us))
    solver.initialize_controls(us)

    sol = solver.solve()
    xs, us = solver.get_trajectory()
    print("terminal state:", xs[-1], " goal:", xT)
    print("max violation:", float(sol.max_violation))
    return sol


if __name__ == "__main__":
    main()
