"""Parameter sensitivities dJ*/dw (examples/sensitivity_demo.py on the
port; ops/sensitivity.py).

A tracking problem whose stage costs follow a parameterized target path:
one adjoint sweep returns the gradient of the optimal cost with respect to
every per-timestep parameter at once.  The solve is the SL batched solver
on one lane (per-instance semantics), so on the card the example's own
lambdas run on K3/K4 through generated device functions
(``ops/device_functions.py``).
Run: python -m iterativelqr_tpu_torch.examples.sensitivity_demo [--device cuda]
"""

import argparse

import numpy as np
import torch

from iterativelqr_tpu_torch import (Constraint, Cost, Dynamics, Options, build_spec,
                                    make_batched_solve_fn, solution_parameter_gradient)


def demo_problem(T, device):
    """A double integrator with closed-over matrices, a target path in the
    per-step parameters w (num_parameter=2), and x_T = w_T."""
    A = torch.tensor([[1.0, 0.2], [0.0, 1.0]], dtype=torch.float64, device=device)
    B = torch.tensor([0.0, 0.2], dtype=torch.float64, device=device)
    dyn = Dynamics(lambda x, u, w: A.to(x) @ x + B.to(x) * u[0], 2, 1, num_parameter=2)
    stage = Cost(lambda x, u, w: 0.5 * torch.sum((x - w) ** 2) + 0.05 * torch.sum(u**2),
                 2, 1, num_parameter=2)
    term = Cost(lambda x, u, w: 0.5 * torch.sum((x - w) ** 2), 2, 0, num_parameter=2)
    goal = Constraint(lambda x, u, w: x - w, 2, 0, num_parameter=2)
    return build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                      [Constraint() for _ in range(T - 1)] + [goal])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device, dtype = torch.device(args.device), torch.float64
    T = 11
    spec = demo_problem(T, device)
    # "auto": the rollout kernels on the card (pod_sweep.py says why)
    opts = Options(verbose=False, record_traces=False, forward_kernel="auto")
    solve = make_batched_solve_fn(spec, opts, device=device, dtype=dtype)

    # target path: ramp to (1, 0)
    t = torch.linspace(0.0, 1.0, T, dtype=dtype, device=device)
    ws = torch.stack([t, torch.zeros_like(t)], dim=1)
    sol = solve(torch.zeros((1, T, 2), dtype=dtype, device=device),
                torch.zeros((1, T - 1, 1), dtype=dtype, device=device), ws[None])
    print("solved: violation", float(sol.max_violation[0]))

    g = solution_parameter_gradient(spec, opts, sol, ws[None])[0].cpu().numpy()
    print("\n dJ*/dw_t (sensitivity of optimal cost to each target point):")
    for k in range(T):
        print(f"  t={k:>2}  dJ/dw = [{g[k, 0]:>9.4f}, {g[k, 1]:>9.4f}]")
    print("\nlargest influence:", int(np.argmax(np.abs(g).sum(axis=1))),
          "(the terminal-constraint target dominates)")
    return g


if __name__ == "__main__":
    main()
