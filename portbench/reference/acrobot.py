"""Acrobot swing-up in plain torch, batched over leading lane axes.

The benchmark's own reference for ``configs/acrobot_T101.json``: the
equations of ``numpy_reference.py::acrobot_problem`` (IterativeLQR.jl's
``examples/acrobot.jl``) written again for lanes and any device.  It imports
nothing of the program.  Rows of ``constraints`` follow the program's
padded layout: ``nc`` rows a stage, zero where a stage has none.
"""

from __future__ import annotations

import math

import torch

M1, M2, I1, I2 = 1.0, 1.0, 0.33, 0.33
L1, LC1, LC2 = 1.0, 0.5, 0.5
G, MU1, MU2 = 9.81, 0.1, 0.1


class Problem:
    nx, nu = 4, 1

    def __init__(self, T: int, h: float = 0.1):
        self.T, self.h = T, h
        self.nc = self.nx
        self.goal = (math.pi, 0.0, 0.0, 0.0)
        # [T, nc]: rows that exist (only the terminal goal) and inequalities
        self.cmask = torch.zeros((T, self.nc), dtype=torch.bool)
        self.cmask[-1] = True
        self.ineq = torch.zeros((T, self.nc), dtype=torch.bool)

    def continuous(self, x, u):
        q1, q2, v1, v2 = x.unbind(-1)
        a = I1 + I2 + M2 * L1 ** 2 + 2.0 * M2 * L1 * LC2 * torch.cos(q2)
        b = I2 + M2 * L1 * LC2 * torch.cos(q2)
        c = I2
        det = a * c - b * b
        tau1 = -M1 * G * LC1 * torch.sin(q1) - M2 * G * (
            L1 * torch.sin(q1) + LC2 * torch.sin(q1 + q2))
        tau2 = -M2 * G * LC2 * torch.sin(q1 + q2)
        c11 = -2.0 * M2 * L1 * LC2 * torch.sin(q2) * v2
        c12 = -M2 * L1 * LC2 * torch.sin(q2) * v2
        c21 = M2 * L1 * LC2 * torch.sin(q2) * v1
        rhs1 = -(c11 * v1 + c12 * v2) + tau1 - MU1 * v1
        rhs2 = -(c21 * v1) + tau2 + u[..., 0] - MU2 * v2
        qdd1 = (c * rhs1 - b * rhs2) / det
        qdd2 = (-b * rhs1 + a * rhs2) / det
        return torch.stack([v1, v2, qdd1, qdd2], dim=-1)

    def discrete(self, x, u):
        """Explicit midpoint (RK2) step of length h."""
        h = self.h
        return x + h * self.continuous(x + 0.5 * h * self.continuous(x, u), u)

    def cost(self, xs, us):
        """[..., T, 4], [..., T-1, 1] -> [...]: 0.1 (|v|^2 over every knot +
        |u|^2 over every stage)."""
        return 0.1 * ((xs[..., 2:4] ** 2).sum(dim=(-1, -2)) + (us ** 2).sum(dim=(-1, -2)))

    def constraints(self, xs, us):
        """[..., T, nc]: the terminal goal x_T - (pi, 0, 0, 0)."""
        c = xs.new_zeros(xs.shape[:-2] + (self.T, self.nc))
        c[..., -1, :] = xs[..., -1, :] - xs.new_tensor(self.goal)
        return c


def make(config: dict) -> Problem:
    return Problem(config["T"], config["dt"])
