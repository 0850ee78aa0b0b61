"""User problems written as plain torch functions (lambdas and closures, no
registered model) for the tests of the generated device functions
(iterativelqr_tpu_torch/ops/device_functions.py): the stage functions of
examples/mpc_farm.py and examples/sensitivity_demo.py in torch, and the
acrobot's functions wrapped in lambdas, which the rollout kernels' registry
does not recognise; models/quadrotor.py's and models/car.py's problems
written with matrices, constant indices and norms, and a small problem of
the ops the generator lowers since products and the wider math; the
padded problems of tests/test_padding.py, a planar quadrotor at (6, 2) and
a team of three quadrotors at (36, 12), built in either package, and a
pendulum with every derivative written by hand.  Imports
torch and the port only."""

import torch

from iterativelqr_tpu_torch import Constraint, Cost, Dynamics, build_spec
from iterativelqr_tpu_torch.models import acrobot, particle, quadrotor


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
    goal = Constraint(lambda x, u: x - xT, 2, 0)
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


def _cast(x, *consts):
    """Closed-over constants in the dtype of ``x``: a stage function runs
    on f32 and f64 tensors, and a matrix product does not promote."""
    return [c.to(x) for c in consts]


def quadrotor_matrix(T, device="cpu"):
    """models/quadrotor.py's problem (12 states, 4 rotor thrusts, RK2 at
    h = 0.05, thrust bounds on every stage, the hover at the goal) written
    with matrices, as users write it: the rotation matrix built with
    ``stack`` and used through ``@``, the inertia a diagonal matrix with
    ``torch.linalg.cross(w, J @ w)``, the Euler-rate map a matrix, and
    quadratic costs ``e @ Q @ e + du @ R @ du`` with closed-over diagonal
    Q and R equal to the model's weights.  The math is the model's, in
    another order of operations."""
    kw = dict(dtype=torch.float64, device=device)
    J = torch.diag(torch.tensor(quadrotor.INERTIA, **kw))
    J_inv = torch.diag(1.0 / torch.tensor(quadrotor.INERTIA, **kw))
    arm, kt = quadrotor.ARM, quadrotor.KT
    # thrusts -> body torques (x-configuration)
    mix = torch.tensor([[0.0, arm, 0.0, -arm], [-arm, 0.0, arm, 0.0], [kt, -kt, kt, -kt]], **kw)
    e_z = torch.tensor([0.0, 0.0, 1.0], **kw)
    g = torch.tensor([0.0, 0.0, quadrotor.GRAVITY], **kw)
    goal = torch.tensor((1.0, 1.0, 1.0) + (0.0,) * 9, **kw)
    Q = torch.diag(torch.tensor([1.0] * 3 + [0.5] * 3 + [0.1] * 6, **kw))
    R = 0.05 * torch.eye(4, **kw)
    hover = torch.full((4,), quadrotor.HOVER, **kw)
    u_min, u_max = torch.zeros(4, **kw), torch.full((4,), 6.0, **kw)

    def continuous(x, u):
        v, w = x[6:9], x[9:12]
        roll, pitch, yaw = x[3:6]
        cr, sr, cp, sp = torch.cos(roll), torch.sin(roll), torch.cos(pitch), torch.sin(pitch)
        cy, sy = torch.cos(yaw), torch.sin(yaw)
        one, zero = torch.ones_like(cr), torch.zeros_like(cr)
        rot = torch.stack([
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr]),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr]),
            torch.stack([-sp, cp * sr, cp * cr]),
        ])
        J_, J_inv_, mix_, e_z_, g_ = _cast(x, J, J_inv, mix, e_z, g)
        acc = rot @ (e_z_ * (torch.sum(u) / quadrotor.MASS)) - g_
        wdot = J_inv_ @ (mix_ @ u - torch.linalg.cross(w, J_ @ w))
        tp = torch.tan(pitch)
        euler = torch.stack([torch.stack([one, sr * tp, cr * tp]),
                             torch.stack([zero, cr, -sr]),
                             torch.stack([zero, sr / cp, cr / cp])])
        return torch.cat([v, euler @ w, acc, wdot])

    def dynamics(x, u):
        return x + 0.05 * continuous(x + 0.025 * continuous(x, u), u)

    def stage_cost(x, u):
        goal_, hover_, Q_, R_ = _cast(x, goal, hover, Q, R)
        e, du = x - goal_, u - hover_
        return e @ Q_ @ e + du @ R_ @ du

    def terminal_cost(x, u):
        e = x - goal.to(x)
        return e @ e

    def limits(x, u):
        lo, hi = _cast(x, u_min, u_max)
        return torch.cat([lo - u, u - hi])

    dyn = Dynamics(dynamics, 12, 4)
    stage = Cost(stage_cost, 12, 4)
    term = Cost(terminal_cost, 12, 0)
    bounds = Constraint(limits, 12, 4, indices_inequality=range(8))
    hover_goal = Constraint(lambda x, u: x - goal.to(x), 12, 0)
    return build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                      [bounds] * (T - 1) + [hover_goal])


def car_user(T, device="cpu"):
    """models/car.py's problem (unicycle, RK2 at h = 0.1, control box and
    the circular obstacle on every stage, the goal equality and the
    obstacle at the end) as users write it: the position taken as
    ``x[torch.tensor([0, 1])]``, the obstacle row ``r2 -
    torch.linalg.vector_norm(e) ** 2`` and costs ``d @ Q @ d``."""
    kw = dict(dtype=torch.float64, device=device)
    goal = torch.tensor([1.0, 1.0, 0.0], **kw)
    center = torch.tensor([0.5, 0.5], **kw)
    pos = torch.tensor([0, 1], device=device)
    Q, R, Q_T = torch.eye(3, **kw), 1.0e-2 * torch.eye(2, **kw), 1000.0 * torch.eye(3, **kw)
    lo, hi = torch.full((2,), -5.0, **kw), torch.full((2,), 5.0, **kw)
    r2 = 0.1 ** 2

    def continuous(x, u):
        return torch.stack([u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]), u[1]])

    def obstacle(x):
        return (r2 - torch.linalg.vector_norm(x[pos] - center.to(x)) ** 2).reshape(1)

    def stage_cost(x, u):
        d = x - goal.to(x)
        return d @ Q.to(x) @ d + u @ R.to(x) @ u

    def terminal_cost(x, u):
        d = x - goal.to(x)
        return d @ Q_T.to(x) @ d

    def stage_con(x, u):
        lo_, hi_ = _cast(x, lo, hi)
        return torch.cat([lo_ - u, u - hi_, obstacle(x)])

    dyn = Dynamics(lambda x, u: x + 0.1 * continuous(x + 0.05 * continuous(x, u), u), 3, 2)
    stage = Cost(stage_cost, 3, 2)
    term = Cost(terminal_cost, 3, 0)
    con = Constraint(stage_con, 3, 2, indices_inequality=range(5))
    con_T = Constraint(lambda x, u: torch.cat([x - goal.to(x), obstacle(x)]), 3, 2,
                       indices_inequality=[3])
    return build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                      [con] * (T - 1) + [con_T])


def pendulum_manual(T, device="cpu"):
    """A pendulum (2 states, 1 torque, explicit Euler at h = 0.05) whose
    stage objects carry every manual derivative: the dynamics' Jacobians,
    the costs' gradients and Hessians and the constraints' Jacobians (the
    torque box on every stage, the upright goal at the end), written by
    hand in place of torch.func's.  Each is made from its inputs (``ones``
    and ``zeros`` of x or u): torch.func's vmap over a trailing lane axis
    refuses an output that does not depend on them."""
    h, g = 0.05, 9.81
    goal = torch.tensor([3.141592653589793, 0.0], dtype=torch.float64, device=device)
    eye = lambda x: torch.diag(torch.ones_like(x))
    zero = lambda x: torch.zeros_like(x[0])

    def dynamics(x, u):
        return torch.stack([x[0] + h * x[1], x[1] + h * (u[0] - g * torch.sin(x[0]))])

    def dyn_x(x, u):
        one = torch.ones_like(x[0])
        return torch.stack([torch.stack([one, h * one]),
                            torch.stack([-h * g * torch.cos(x[0]), one])])

    def dyn_u(x, u):
        return torch.stack([torch.zeros_like(u), h * torch.ones_like(u)])

    def stage_cost(x, u):
        return 0.5 * torch.sum((x - goal.to(x)) ** 2) + 0.05 * torch.sum(u ** 2)

    def terminal_cost(x, u):
        return 50.0 * torch.sum((x - goal.to(x)) ** 2)

    dyn = Dynamics(dynamics, 2, 1, jacobian_state=dyn_x, jacobian_action=dyn_u)
    stage = Cost(stage_cost, 2, 1,
                 gradient_state=lambda x, u: x - goal.to(x),
                 gradient_action=lambda x, u: 0.1 * u,
                 hessian_state_state=lambda x, u: eye(x),
                 hessian_action_action=lambda x, u: 0.1 * torch.ones_like(u)[:, None],
                 hessian_action_state=lambda x, u: torch.stack([zero(x), zero(x)])[None])
    term = Cost(terminal_cost, 2, 0,
                gradient_state=lambda x, u: 100.0 * (x - goal.to(x)),
                gradient_action=lambda x, u: zero(x)[None][:0],
                hessian_state_state=lambda x, u: 100.0 * eye(x),
                hessian_action_action=lambda x, u: eye(x)[:0, :0],
                hessian_action_state=lambda x, u: eye(x)[:0])
    box = Constraint(lambda x, u: torch.cat([u - 2.0, -u - 2.0]), 2, 1,
                     indices_inequality=(0, 1),
                     jacobian_state=lambda x, u: 0.0 * eye(x),
                     jacobian_action=lambda x, u: torch.stack([torch.ones_like(u),
                                                               -torch.ones_like(u)]))
    upright = Constraint(lambda x, u: x - goal.to(x), 2, 0,
                         jacobian_state=lambda x, u: eye(x),
                         jacobian_action=lambda x, u: eye(x)[:, :0])
    return build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                      [box] * (T - 1) + [upright])


def mixed_problem(T, device="cpu"):
    """A small user problem (3 states, 2 controls) that combines the ops
    the device-function generator took on last: a quadratic form ``x @ Q
    @ x`` (Q closed over), constant indexing, ``atan2`` (a heading error
    wrapped to (-pi, pi]) and a ``vector_norm`` obstacle row.  A unicycle
    steered to (1, 0.5) heading 0.3, around a disc at (0.5, 0.2) of radius
    0.15; the goal is an equality at the end."""
    kw = dict(dtype=torch.float64, device=device)
    Q = torch.tensor([[1.0, 0.2], [0.2, 0.5]], **kw)
    goal = torch.tensor([1.0, 0.5], **kw)
    center = torch.tensor([0.5, 0.2], **kw)
    idx = torch.tensor([0, 1], device=device)

    def dynamics(x, u):
        v = torch.stack([u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]), u[1]])
        return x + 0.1 * v

    def heading(x):
        d = x[2] - 0.3
        return torch.atan2(torch.sin(d), torch.cos(d))

    def stage_cost(x, u):
        e = x[idx] - goal.to(x)
        return e @ Q.to(x) @ e + 0.1 * heading(x) ** 2 + 0.05 * (u @ u)

    def terminal_cost(x, u):
        e = x[idx] - goal.to(x)
        return 10.0 * (e @ Q.to(x) @ e)

    def stage_con(x, u):
        obstacle = 0.15 - torch.linalg.vector_norm(x[idx] - center.to(x))
        return obstacle.reshape(1)

    dyn = Dynamics(dynamics, 3, 2)
    stage = Cost(stage_cost, 3, 2)
    term = Cost(terminal_cost, 3, 0)
    con = Constraint(stage_con, 3, 2, indices_inequality=(0,))
    goal_con = Constraint(lambda x, u: x[idx] - goal.to(x), 3, 0)
    return build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                      [con] * (T - 1) + [goal_con])


def _array(xp, values, device):
    """A closed-over f64 constant: on ``device`` for torch, a jnp array for
    the JAX package (``xp`` is torch or jax.numpy)."""
    if xp is torch:
        return torch.tensor(values, dtype=torch.float64, device=device)
    return xp.asarray(values, dtype=xp.float64)


def padded_actionless(pkg, xp, inert=False, device="cpu"):
    """tests/test_padding.py's actionless problem, T=9, in either package
    (``pkg`` the port or the JAX package, ``xp`` torch or jax.numpy): even
    steps actuated, odd steps pure drift (num_action=0, the u-mask path);
    ``inert``: odd actions that exist, move nothing and are penalized."""
    T = 9
    A = _array(xp, [[1.0, 0.3], [0.0, 1.0]], device)
    B = _array(xp, [0.0, 0.3], device)
    goal = _array(xp, [1.0, 0.0], device)
    act = pkg.Dynamics(lambda x, u: A @ x + B * u[0], 2, 1)
    drift = pkg.Dynamics(lambda x, u: A @ x, 2, 1 if inert else 0)
    cost_act = pkg.Cost(lambda x, u: 0.1 * (x @ x + u @ u), 2, 1)
    cost_drift = cost_act if inert else pkg.Cost(lambda x, u: 0.1 * (x @ x), 2, 0)
    cost_term = pkg.Cost(lambda x, u: 0.1 * (x @ x), 2, 0)
    cons = [pkg.Constraint() for _ in range(T - 1)] + [
        pkg.Constraint(lambda x, u: x - goal, 2, 0)]
    return pkg.build_spec([act if t % 2 == 0 else drift for t in range(T - 1)],
                          [cost_act if t % 2 == 0 else cost_drift for t in range(T - 1)]
                          + [cost_term], cons)


def padded_lift_project(pkg, xp, device="cpu"):
    """tests/test_padding.py's problem whose state dimension changes along
    the horizon, R2 -> R3 -> R3 -> R2 (T=4), in either package."""
    stack = (lambda *a: xp.stack(a)) if xp is torch else (lambda *a: xp.array(a))
    lift = pkg.Dynamics(lambda x, u: stack(x[0], x[1], x[0] + x[1] + u[0]), 2, 1)
    mix3 = pkg.Dynamics(lambda x, u: stack(x[0] + 0.1 * x[2], x[1] + u[0],
                                           0.5 * x[2] + u[1]), 3, 2)
    proj = pkg.Dynamics(lambda x, u: stack(x[0] + u[0], x[1] + x[2]), 3, 1)
    goal = _array(xp, [0.5, -0.2], device)
    objective = [pkg.Cost(lambda x, u: 0.1 * (x @ x + u @ u), 2, 1),
                 pkg.Cost(lambda x, u: 0.1 * (x @ x + u @ u), 3, 2),
                 pkg.Cost(lambda x, u: 0.1 * (x @ x + u @ u), 3, 1),
                 pkg.Cost(lambda x, u: 0.1 * (x @ x), 2, 0)]
    constraints = [pkg.Constraint(), pkg.Constraint(), pkg.Constraint(),
                   pkg.Constraint(lambda x, u: x - goal, 2, 0)]
    return pkg.build_spec([lift, mix3, proj], objective, constraints)


# the planar quadrotor's parameters (RobotZoo.jl's PlanarQuadrotor) and
# the problem's: hover thrust a rotor, the thrust box, the goal hover
PQ_MASS, PQ_ARM, PQ_G, PQ_DT = 1.0, 0.3, 9.81, 0.05
PQ_J = 0.2 * PQ_MASS * PQ_ARM ** 2
PQ_HOVER = 0.5 * PQ_MASS * PQ_G
PQ_UMAX = 0.75 * PQ_MASS * PQ_G
PQ_GOAL = (2.0, 1.0, 0.0, 0.0, 0.0, 0.0)
PQ_Q = (1.0, 1.0, 1.0, 0.1, 0.1, 0.1)
PQ_R = 0.1
PQ_QF = 10.0


def planar_quadrotor(pkg, xp, T=101):
    """RobotZoo.jl's ``PlanarQuadrotor`` as a user writes it, in either
    package (``pkg`` the port or the JAX package, ``xp`` torch or
    jax.numpy): n = 6 (x, y, theta and their rates), m = 2 rotor thrusts,
    mass 1.0, arm 0.3, J = 0.2 mass arm^2, g = 9.81; explicit RK4 at dt =
    0.05; quadratic tracking of the hover at (x, y) = (2, 1) about the
    hover thrust; the terminal goal as an equality; the thrust box 0 <= u_i
    <= 0.75 mass g as four inequality rows a step.  Constants are Python
    floats, so the functions keep the inputs' dtype."""
    def accel(x, u):
        thrust = (u[0] + u[1]) / PQ_MASS
        return xp.stack([x[3], x[4], x[5], thrust * xp.sin(x[2]),
                         thrust * xp.cos(x[2]) - PQ_G,
                         (0.5 * PQ_ARM / PQ_J) * (u[1] - u[0])])

    def rk4(x, u):
        k1 = accel(x, u)
        k2 = accel(x + (0.5 * PQ_DT) * k1, u)
        k3 = accel(x + (0.5 * PQ_DT) * k2, u)
        k4 = accel(x + PQ_DT * k3, u)
        return x + (PQ_DT / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def tracking(x):
        return sum(0.5 * q * (x[i] - g) ** 2 for i, (q, g) in enumerate(zip(PQ_Q, PQ_GOAL)))

    dyn = pkg.Dynamics(rk4, 6, 2)
    stage = pkg.Cost(lambda x, u: tracking(x) + 0.5 * PQ_R * ((u[0] - PQ_HOVER) ** 2
                                                              + (u[1] - PQ_HOVER) ** 2), 6, 2)
    term = pkg.Cost(lambda x, u: PQ_QF * tracking(x), 6, 0)
    box = pkg.Constraint(lambda x, u: xp.stack([-u[0], -u[1], u[0] - PQ_UMAX, u[1] - PQ_UMAX]),
                         6, 2, indices_inequality=(0, 1, 2, 3))
    goal = pkg.Constraint(lambda x, u: xp.stack([x[i] - g for i, g in enumerate(PQ_GOAL)]), 6, 0)
    return pkg.build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                          [box] * (T - 1) + [goal])


def planar_quadrotor_inputs(B, T, seed=0, start=(0.0, 0.0)):
    """Initial guesses: hover at ``start`` (x, y; the origin by default)
    plus 0.1 N(0, 1) on every state (a numpy seed) spliced into zero
    states, hover thrust on every step, no parameters (numpy, f64)."""
    import numpy as np

    xs = np.zeros((B, T, 6))
    xs[:, 0] = 0.1 * np.random.default_rng(seed).standard_normal((B, 6))
    xs[:, 0, :2] += start
    return xs, np.full((B, T - 1, 2), PQ_HOVER), np.zeros((B, T, 0))


# the team of three quadrotors: the starts on a circle of radius TEAM_R
# about the origin at 120 degrees, each goal the point across the circle,
# so that every straight path crosses the centre; the thrust box of
# models/quadrotor.py's problem; the least distance between two rotorcraft
TEAM_R = 0.75
TEAM_DIRECTIONS = ((1.0, 0.0), (-0.5, 0.8660254037844386), (-0.5, -0.8660254037844386))


def team_starts(radius=TEAM_R):
    return tuple((radius * c, radius * s, 0.0) for c, s in TEAM_DIRECTIONS)


def team_goals(radius=TEAM_R):
    return tuple((-x, -y, z) for x, y, z in team_starts(radius))


TEAM_UMAX = 6.0
TEAM_SEP = 0.3
TEAM_PAIRS = ((0, 1), (0, 2), (1, 2))


def quadrotor_team(pkg, xp, T=41, radius=TEAM_R):
    """Three quadrotors planned as one system, in either package (``pkg``
    the port or the JAX package, ``xp`` torch or jax.numpy): each stepped
    by its own package's ``models/quadrotor.py::quadrotor_discrete``, so n
    = 36 (three 12-state blocks), m = 12 (three 4-rotor blocks).  Each
    tracks its goal with models/quadrotor.py's weights (1 on the position
    error, 0.5 on the angles, 0.1 on the velocities and rates, 0.05 on the
    thrusts about hover; 1 on the whole terminal error); a step's
    inequality rows are the thrust box 0 <= u <= 6 (24 rows) and the
    separations |p_i - p_j|^2 >= 0.3^2 of the three pairs (3 rows); the
    terminal goal is an equality (36 rows).  The goals lie across a circle
    of ``radius`` from the starts (``team_starts``, ``team_goals``), so
    every straight path crosses the centre at the same time.  Constants
    are Python floats, so the functions keep the inputs' dtype."""
    import importlib

    quad = importlib.import_module(pkg.__name__ + ".models.quadrotor")
    hover = quad.MASS * quad.GRAVITY / 4.0
    goals = team_goals(radius)
    goal = [v for g in goals for v in g + (0.0,) * 9]

    def dynamics(x, u):
        return xp.concatenate([quad.quadrotor_discrete(x[12 * i:12 * i + 12], u[4 * i:4 * i + 4])
                               for i in range(3)])

    def stage_cost(x, u):
        total = 0.0
        for i, g in enumerate(goals):
            xi, du = x[12 * i:12 * i + 12], u[4 * i:4 * i + 4] - hover
            pos = sum((xi[k] - g[k]) ** 2 for k in range(3))
            total = (total + 1.0 * pos + 0.5 * xp.sum(xi[3:6] * xi[3:6])
                     + 0.1 * xp.sum(xi[6:12] * xi[6:12]) + 0.05 * xp.sum(du * du))
        return total

    def terminal_cost(x, u):
        return 1.0 * sum((x[k] - g) ** 2 for k, g in enumerate(goal))

    def separation(x, i, j):
        d = x[12 * i:12 * i + 3] - x[12 * j:12 * j + 3]
        return TEAM_SEP ** 2 - xp.sum(d * d)

    def stage_con(x, u):
        return xp.concatenate([-u, u - TEAM_UMAX,
                               xp.stack([separation(x, i, j) for i, j in TEAM_PAIRS])])

    dyn = pkg.Dynamics(dynamics, 36, 12)
    stage = pkg.Cost(stage_cost, 36, 12)
    term = pkg.Cost(terminal_cost, 36, 0)
    limits = pkg.Constraint(stage_con, 36, 12, indices_inequality=range(27))
    goal_con = pkg.Constraint(lambda x, u: xp.stack([x[k] - g for k, g in enumerate(goal)]), 36, 0)
    return pkg.build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                          [limits] * (T - 1) + [goal_con])


def quadrotor_team_inputs(B, T, seed=0, radius=TEAM_R):
    """Initial guesses: each quadrotor hovering at its start over the whole
    horizon (hover thrust on every rotor and step), the initial states
    plus 0.1 N(0, 1) on every state (a numpy seed); no parameters (numpy,
    f64).  (Zero states after t = 0 would put the three at one point, where
    the separation rows have no gradient.)"""
    import numpy as np

    hover = quadrotor.MASS * quadrotor.GRAVITY / 4.0
    xs = np.zeros((B, T, 36))
    for i, p in enumerate(team_starts(radius)):
        xs[:, :, 12 * i:12 * i + 3] = p
    xs[:, 0] += 0.1 * np.random.default_rng(seed).standard_normal((B, 36))
    return xs, np.full((B, T - 1, 12), hover), np.zeros((B, T, 0))


def math_problem(T, device="cpu"):
    """A small problem (3 states, 2 controls) whose stage functions use
    every elementwise math function and reduction the device-function
    generator lowers besides the arithmetic: atan2, atan, asin, acos, sinh,
    cosh, asinh, acosh, atanh, sigmoid, softplus, log1p, expm1, rsqrt,
    reciprocal, sign, relu, erf, hypot, a real power, amax, amin, prod,
    mean and vector norms at ord 2, 1 and inf.  Each term is bounded, so
    random rollouts stay finite; it holds every C math call the generated
    headers print against torch on the card."""
    kw = dict(dtype=torch.float64, device=device)
    Q = torch.tensor([[1.0, 0.1, 0.0], [0.1, 0.5, 0.0], [0.0, 0.0, 0.2]], **kw)
    goal = torch.tensor([0.5, -0.2, 0.1], **kw)
    idx = torch.tensor([0, 2], device=device)
    sp = torch.nn.functional.softplus

    def dynamics(x, u):
        f = torch.stack([
            torch.atan2(x[1], 1.0 + x[0] * x[0]) + 0.1 * torch.asinh(x[2])
            + 0.1 * torch.sigmoid(u[0]) - 0.05 * torch.erf(x[0])
            + 0.1 * torch.sign(x[1]) * torch.relu(u[1]),
            0.1 * (torch.sinh(0.5 * torch.tanh(x[2])) + torch.cosh(0.5 * torch.tanh(x[0])))
            + torch.atan(u[0]) + 0.1 * torch.asin(0.5 * torch.tanh(x[1]))
            + 0.1 * torch.acos(0.5 * torch.tanh(x[2])) - 0.25,
            0.1 * torch.hypot(x[0], u[1]) + 0.1 * torch.log1p(x[1] * x[1])
            - 0.1 * torch.expm1(-x[2] * x[2]) + 0.1 * torch.rsqrt(1.0 + x[0] * x[0])
            + 0.1 * torch.reciprocal(2.0 + x[1] * x[1]) + 0.1 * sp(u[1])
            + 0.01 * (1.0 + x[2] * x[2]) ** 1.5 + 0.05 * torch.acosh(1.0 + x[0] * x[0])
            + 0.1 * torch.atanh(0.5 * torch.tanh(u[0])) - 0.3,
        ])
        return x + 0.05 * f

    def stage_cost(x, u):
        e = x - goal.to(x)
        return (e @ Q.to(x) @ e + 0.1 * (u @ u) + 0.05 * torch.amax(x * x) - 0.05 * torch.amin(x)
                + 0.05 * torch.prod(1.0 + 0.1 * torch.tanh(x)) + 0.1 * torch.mean(e * e)
                + 0.01 * torch.linalg.vector_norm(u, 1)
                + 0.01 * torch.linalg.vector_norm(e, float("inf")))

    dyn = Dynamics(dynamics, 3, 2)
    stage = Cost(stage_cost, 3, 2)
    def terminal_cost(x, u):
        e = x - goal.to(x)
        return 10.0 * (e @ Q.to(x) @ e)

    term = Cost(terminal_cost, 3, 0)
    con = Constraint(lambda x, u: (torch.linalg.vector_norm(x[idx]) - 3.0).reshape(1), 3, 2,
                     indices_inequality=(0,))
    goal_con = Constraint(lambda x, u: x - goal.to(x), 3, 0)
    return build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term], [con] * (T - 1) + [goal_con])
