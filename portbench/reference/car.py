"""Unicycle car around a circular obstacle in plain torch, batched over
leading lane axes.

The benchmark's own reference for ``configs/car_T51.json``: the equations
of ``numpy_reference.py::car_problem`` (IterativeLQR.jl's
``examples/car.jl``) written again for lanes and any device.  It imports
nothing of the program.  Rows of ``constraints`` follow the program's
padded layout: 5 rows a stage (the control box, lower then upper, and the
obstacle), at the end the goal's 3 rows and the obstacle, one zero row.
"""

from __future__ import annotations

import torch


class Problem:
    nx, nu = 3, 2

    def __init__(self, T: int, h: float, goal=(1.0, 1.0, 0.0), u_lower: float = -5.0,
                 u_upper: float = 5.0, obstacle_center=(0.5, 0.5),
                 obstacle_radius: float = 0.1):
        self.T, self.h = T, h
        self.goal = tuple(goal)
        self.u_lower, self.u_upper = u_lower, u_upper
        self.center, self.r2 = tuple(obstacle_center), obstacle_radius ** 2
        self.nc = 2 * self.nu + 1
        self.cmask = torch.zeros((T, self.nc), dtype=torch.bool)
        self.cmask[:-1] = True
        self.cmask[-1, :self.nx + 1] = True
        self.ineq = torch.zeros((T, self.nc), dtype=torch.bool)
        self.ineq[:-1] = True
        self.ineq[-1, self.nx] = True

    def continuous(self, x, u):
        th = x[..., 2]
        return torch.stack([u[..., 0] * torch.cos(th), u[..., 0] * torch.sin(th), u[..., 1]],
                           dim=-1)

    def discrete(self, x, u):
        """Explicit midpoint (RK2) step of length h."""
        h = self.h
        return x + h * self.continuous(x + 0.5 * h * self.continuous(x, u), u)

    def cost(self, xs, us):
        """[..., T, 3], [..., T-1, 2] -> [...]: |x_t - goal|^2 over the
        stages, 1e-2 |u|^2, and 1000 |x_T - goal|^2."""
        e = xs - xs.new_tensor(self.goal)
        return ((e[..., :-1, :] ** 2).sum(dim=(-1, -2)) + 1e-2 * (us ** 2).sum(dim=(-1, -2))
                + 1000.0 * (e[..., -1, :] ** 2).sum(-1))

    def obstacle(self, xs):
        """r^2 - |p - center|^2 of each knot's position."""
        e = xs[..., :2] - xs.new_tensor(self.center)
        return self.r2 - (e ** 2).sum(-1)

    def constraints(self, xs, us):
        c = xs.new_zeros(xs.shape[:-2] + (self.T, self.nc))
        nu = self.nu
        c[..., :-1, :nu] = self.u_lower - us
        c[..., :-1, nu:2 * nu] = us - self.u_upper
        c[..., :-1, 2 * nu] = self.obstacle(xs[..., :-1, :])
        c[..., -1, :self.nx] = xs[..., -1, :] - xs.new_tensor(self.goal)
        c[..., -1, self.nx] = self.obstacle(xs[..., -1, :])
        return c


def make(config: dict) -> Problem:
    return Problem(config["T"], config["dt"], **config.get("problem", {}))
