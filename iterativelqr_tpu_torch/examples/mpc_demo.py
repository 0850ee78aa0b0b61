"""Receding-horizon MPC with disturbance rejection (examples/mpc_demo.py
on the port; core/mpc.py).

A particle is repeatedly pushed off course by noise; each MPC step shifts
the previous plan, injects the measured state, re-solves warm-started
(carrying the AL duals) and applies the first action.
Run: python -m iterativelqr_tpu_torch.examples.mpc_demo [--device cuda]
"""

import argparse

import numpy as np
import torch

from iterativelqr_tpu_torch import Constraint, Cost, Dynamics, Options, build_spec
from iterativelqr_tpu_torch.core.mpc import make_mpc_controller
from iterativelqr_tpu_torch.models import particle


def tracking_problem(T, device):
    """The particle with tracking costs toward the goal (the library
    problem's origin-centred cost would park a receding-horizon controller
    at the origin) and the terminal goal equality; returns (spec, goal)."""
    xT = torch.tensor([1.0, 0.0], dtype=torch.float64, device=device)
    dyn = Dynamics(particle.particle_discrete, 2, 1)
    stage = Cost(lambda x, u: 0.5 * torch.sum((x - xT.to(x)) ** 2) + 0.1 * torch.sum(u**2), 2, 1)
    term = Cost(lambda x, u: 0.5 * torch.sum((x - xT.to(x)) ** 2), 2, 0)
    # the probe of the row count runs on the CPU: given here
    goal = Constraint(lambda x, u: x - xT.to(x), 2, 0, num_constraint=2)
    spec = build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                      [Constraint() for _ in range(T - 1)] + [goal])
    return spec, xT


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device, dtype = torch.device(args.device), torch.float64
    T = 11
    spec, xT = tracking_problem(T, device)
    # the controller's warm-start policy (closed-loop shift re-roll, dual
    # and capped-penalty carry, step-tightened objective tolerance) is the
    # default (core/mpc.py)
    opts = Options(verbose=False, record_traces=False)
    init, step = make_mpc_controller(spec, opts, device=device)

    ws = torch.zeros((T, max(spec.npar, 0)), dtype=dtype, device=device)
    state = init(torch.zeros((T, spec.nx), dtype=dtype, device=device),
                 torch.zeros((T - 1, spec.nu), dtype=dtype, device=device))

    f = spec.dyn_eval[0]
    x = torch.tensor([-0.6, 0.4], dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    print(f"{'step':>4} {'x':>24} {'u0':>9} {'plan viol':>10}")
    for i in range(30):
        out = step(state, x, ws)
        state = out.state
        noise = 0.02 * rng.standard_normal(2) if i < 5 else np.zeros(2)
        x = f(x, out.action, ws[0]) + torch.as_tensor(noise, dtype=dtype, device=device)
        if i % 3 == 0 or i >= 27:
            print(f"{i:>4} [{float(x[0]):>10.4f} {float(x[1]):>10.4f}] "
                  f"{float(out.action[0]):>9.4f} {float(out.solution.max_violation):>10.2e}")
    print("\nfinal measured state:", x.cpu().numpy(), " goal:", xT.cpu().numpy())
    return x


if __name__ == "__main__":
    main()
