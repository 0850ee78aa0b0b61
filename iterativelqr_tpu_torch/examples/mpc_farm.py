"""A batched MPC farm: many receding-horizon controllers stepping in
lockstep through the SL batched solver with dual warm starts
(examples/mpc_farm.py on the port).

Serving-scale MPC (one controller a vehicle, arm or plant) takes the
batched solve, not a vmap of per-instance controllers: each step re-solves
B problems warm-started from the shifted plans, carrying the AL
multipliers (``make_batched_solve_fn(dual_warm_start=True)``).  The stage
functions are the example's own lambdas around a closed-over goal; on the
card their rollouts run on K3/K4 through generated device functions
(``ops/device_functions.py``).

Each farm step:
  1. shift every plan one step and re-roll it closed-loop from the measured
     state (dynamic consistency: core/mpc.py says why),
  2. batched warm re-solve (duals and capped penalties carried),
  3. apply each instance's first action to its (noisy) plant.

Run: python -m iterativelqr_tpu_torch.examples.mpc_farm [--device cuda]
"""

import argparse

import numpy as np
import torch

from iterativelqr_tpu_torch import Constraint, Cost, Dynamics, Options, build_spec
from iterativelqr_tpu_torch.models import particle
from iterativelqr_tpu_torch.ops.batching import lane_eval
from iterativelqr_tpu_torch.ops.rollout import closed_loop_rollout, open_loop_rollout
from iterativelqr_tpu_torch.parallel import make_batched_solve_fn


def farm_problem(T, device):
    """The particle with tracking costs around a closed-over goal xT (on
    the solve's device) and the terminal goal equality, all lambdas."""
    xT = torch.tensor([1.0, 0.0], device=device)
    dyn = Dynamics(particle.particle_discrete, 2, 1)
    stage = Cost(lambda x, u: 0.5 * torch.sum((x - xT) ** 2) + 0.1 * torch.sum(u**2), 2, 1)
    term = Cost(lambda x, u: 0.5 * torch.sum((x - xT) ** 2), 2, 0)
    # the probe of the row count runs on the CPU: given here
    goal = Constraint(lambda x, u: x - xT, 2, 0, num_constraint=2)
    spec = build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                      [Constraint() for _ in range(T - 1)] + [goal])
    return spec, xT


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device, dtype = torch.device(args.device), torch.float32
    T, B, steps = 11, 32, 12
    spec, xT = farm_problem(T, device)
    # "auto": the rollout kernels on the card (pod_sweep.py says why)
    opts = Options(verbose=False, record_traces=False,
                   objective_tolerance=1.0e-8,  # warm re-solves: see core/mpc.py
                   max_penalty=1.0e6, forward_kernel="auto")
    ws = torch.zeros((B, T, max(spec.npar, 0)), dtype=dtype, device=device)
    solve_cold = make_batched_solve_fn(spec, opts, device=device, dtype=dtype)
    solve_warm = make_batched_solve_fn(spec, opts, dual_warm_start=True, device=device,
                                       dtype=dtype)
    shift = lambda a: torch.cat([a[:, 1:], a[:, -1:]], dim=1)

    def farm_step(x_meas, sol):
        """Shift plans, re-roll from the measured states, warm re-solve."""
        xs0, us0 = closed_loop_rollout(spec, shift(sol.xs), shift(sol.us), ws, shift(sol.K),
                                       torch.zeros_like(sol.k), 0.0, x0=x_meas)
        # carried duals shift with the plan; penalties capped at re-entry
        new_sol = solve_warm(xs0, us0, ws, shift(sol.duals),
                             torch.clamp(shift(sol.penalty), max=1.0e4))
        return new_sol, new_sol.us[:, 0]

    # cold start: B particles at random positions
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0.0, 0.3, (B, spec.nx)), dtype=dtype, device=device)
    us = torch.zeros((B, T - 1, spec.nu), dtype=dtype, device=device)
    sol = solve_cold(open_loop_rollout(spec, x, us, ws), us, ws)
    print(f"cold solve: mean iters {float(sol.iterations.float().mean()):.1f}, "
          f"max viol {float(sol.max_violation.max()):.2e}")

    for k in range(steps):
        sol, action = farm_step(x, sol)
        x = lane_eval(spec.dyn_eval[0], x, action, ws[:, 0])
        x = x + torch.as_tensor(rng.normal(0.0, 0.005, tuple(x.shape)), dtype=dtype,
                                device=device)
        if k % 3 == 0 or k == steps - 1:
            dist = float((x - xT.to(dtype)).norm(dim=1).mean())
            print(f"step {k:2d}: warm iters mean {float(sol.iterations.float().mean()):5.1f} "
                  f"max {int(sol.iterations.max()):3d} | plan viol max "
                  f"{float(sol.max_violation.max()):.2e} | dist-to-goal mean {dist:.3f}")
    if not float(sol.max_violation.max()) < 5e-3:
        raise RuntimeError("a plan of the farm is infeasible")
    print("farm ok: every plan feasible at every step")
    return sol


if __name__ == "__main__":
    main()
