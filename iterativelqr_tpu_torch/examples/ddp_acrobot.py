"""Gauss-Newton iLQR against full DDP on the acrobot swing-up
(examples/ddp_acrobot.py on the port).

The reference's backward pass is Gauss-Newton iLQR (reference:
src/backward_pass.jl:42-90); ``Options(ddp=True)`` adds the second-order
dynamics terms sum_i Vx_i * d2f_i with Tassa-style state regularization
(ops/backward.py).
Run: python -m iterativelqr_tpu_torch.examples.ddp_acrobot [--horizon 101]
    [--device cuda]
"""

import argparse

import torch

from iterativelqr_tpu_torch import Options, Solver, rollout
from iterativelqr_tpu_torch.models import acrobot


def solve_with(ddp: bool, T: int = 101, device="cuda"):
    dynamics, objective, constraints, x1, xT = acrobot.problem(T)
    solver = Solver(dynamics, objective, constraints,
                    options=Options(verbose=False, ddp=ddp), device=device)
    us = [torch.full((1,), 0.05, dtype=torch.float64, device=device) for _ in range(T - 1)]
    solver.initialize_states(rollout(dynamics, x1.to(device), us))
    solver.initialize_controls(us)
    return solver.solve()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=101)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sols = {}
    for ddp in (False, True):
        sol = sols[ddp] = solve_with(ddp, args.horizon, args.device)
        name = "full DDP     " if ddp else "Gauss-Newton "
        print(f"{name} objective {float(sol.objective):10.4f}  "
              f"violation {float(sol.max_violation):.2e}  "
              f"iterations {int(sol.iterations)}")
    return sols


if __name__ == "__main__":
    main()
