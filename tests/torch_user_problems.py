"""User problems written as plain torch functions (lambdas and closures, no
registered model) for the tests of the generated device functions
(iterativelqr_tpu_torch/ops/device_functions.py): the stage functions of
examples/mpc_farm.py and examples/sensitivity_demo.py in torch, and the
acrobot's functions wrapped in lambdas, which the rollout kernels' registry
does not recognise.  Imports torch and the port only."""

import torch

from iterativelqr_tpu_torch import Constraint, Cost, Dynamics, build_spec
from iterativelqr_tpu_torch.models import acrobot, particle


def acrobot_lambdas(T):
    """models/acrobot.py's problem with each stage function in a lambda."""
    dyn = Dynamics(lambda x, u: acrobot.acrobot_discrete(x, u), 4, 1)
    stage = Cost(lambda x, u: acrobot.stage_cost(x, u), 4, 1)
    term = Cost(lambda x, u: acrobot.terminal_cost(x, u), 4, 0)
    goal = Constraint(lambda x, u: acrobot.goal_constraint(x, u), 4, 0)
    return build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                      [Constraint() for _ in range(T - 1)] + [goal])


def farm_problem(T, device="cpu"):
    """examples/mpc_farm.py's problem: the particle's dynamics, tracking
    costs around a closed-over goal xT (on the solve's device, in torch's
    default dtype) and the terminal goal equality, all lambdas."""
    xT = torch.tensor([1.0, 0.0], device=device)
    dyn = Dynamics(particle.particle_discrete, 2, 1)
    stage = Cost(lambda x, u: 0.5 * torch.sum((x - xT) ** 2) + 0.1 * torch.sum(u**2), 2, 1)
    term = Cost(lambda x, u: 0.5 * torch.sum((x - xT) ** 2), 2, 0)
    # the probe of the row count runs on the CPU: given here
    goal = Constraint(lambda x, u: x - xT, 2, 0, num_constraint=2)
    return build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                      [Constraint() for _ in range(T - 1)] + [goal])


def demo_problem(T, device="cpu"):
    """examples/sensitivity_demo.py's problem: a double integrator with
    closed-over matrices, a target path in the per-step parameters w
    (num_parameter=2) and the terminal equality x_T = w_T."""
    A = torch.tensor([[1.0, 0.2], [0.0, 1.0]], dtype=torch.float64, device=device)
    B = torch.tensor([0.0, 0.2], dtype=torch.float64, device=device)
    dyn = Dynamics(lambda x, u, w: A.to(x) @ x + B.to(x) * u[0], 2, 1, num_parameter=2)
    stage = Cost(lambda x, u, w: 0.5 * torch.sum((x - w) ** 2) + 0.05 * torch.sum(u**2),
                 2, 1, num_parameter=2)
    term = Cost(lambda x, u, w: 0.5 * torch.sum((x - w) ** 2), 2, 0, num_parameter=2)
    goal = Constraint(lambda x, u, w: x - w, 2, 0, num_parameter=2)
    return build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                      [Constraint() for _ in range(T - 1)] + [goal])
