"""User-facing Solver: a thin stateful shell over the pure solve function.

Counterpart of ``iterativelqr_tpu/core/solver.py`` (its citations of the
reference live there): construct from per-timestep Dynamics / Cost /
Constraint lists, warm-start with ``initialize_states`` /
``initialize_controls``, call ``solve()``, read back ``get_trajectory()``.
The shell only stores the nominal trajectory, the parameter trajectory and
the AL state between solves; every solve is one call of the per-instance
solver (``core/solve.py::make_solve_fn``) on ``device``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..utils.printing import print_solution, solver_info
from .options import Options
from .solve import CallbackState, Solution, make_solve_fn
from .spec import Constraint, Cost, Dynamics, ProblemSpec, build_spec


class Solver:
    """One problem instance.  The solve runs on ``device`` (the card unless
    the caller passes "cpu") in ``dtype`` (f64 unless the caller asks for
    another: the JAX package falls back to f32 only where x64 is off, which
    has no counterpart here)."""

    def __init__(
        self,
        dynamics: Sequence[Dynamics],
        objective: Sequence[Cost],
        constraints: Optional[Sequence[Constraint]] = None,
        parameters: Optional[Sequence] = None,
        options: Options = Options(),
        callback: Optional[Callable[[CallbackState], CallbackState]] = None,
        dtype=torch.float64,
        device="cuda",
    ):
        self.spec: ProblemSpec = build_spec(dynamics, objective, constraints)
        self.options = options
        self.dtype = dtype
        self.device = torch.device(device)
        T, nx, nu, npar = self.spec.T, self.spec.nx, self.spec.nu, self.spec.npar
        z = lambda *s: torch.zeros(s, dtype=dtype, device=self.device)

        # nominal trajectory + parameter trajectory (padded)
        self._xs = z(T, nx)
        self._us = z(T - 1, nu)
        self._ws = z(T, npar)
        if parameters is not None:
            self._ws = self._set_rows(self._ws, parameters)

        self._solve_fn = make_solve_fn(self.spec, options, callback, device=self.device)
        self._callback = callback
        # built on the first warm solve, as in the JAX package
        self._warm_solve_fn = None
        self._duals = None
        self._penalty = None
        self.solution: Optional[Solution] = None

    def _set_rows(self, buf, rows):
        """``buf`` with row t's leading entries set to ``rows[t]`` (a new
        tensor: ``buf`` may be a returned solution's)."""
        buf = buf.clone()
        for t, v in enumerate(rows):
            v = torch.as_tensor(v, dtype=self.dtype, device=self.device).reshape(-1)
            buf[t, : v.shape[0]] = v
        return buf

    # -- warm start -----------------------------------------------------------

    def initialize_states(self, states):
        """Seed nominal states from a [T, n] tensor or a list of per-t
        vectors.  The nominal should be dynamically consistent with the
        seeded controls (``ops/rollout.py::rollout`` makes one)."""
        self._xs = self._set_rows(self._xs, states)
        return self

    def initialize_controls(self, actions):
        self._us = self._set_rows(self._us, actions)
        return self

    # -- solve ----------------------------------------------------------------

    def solve(self, verbose: Optional[bool] = None, warm_start: bool = False) -> Solution:
        """Solve from the current nominal trajectory.  ``warm_start=True``
        also carries the duals and penalties of the previous solve; the
        nominal trajectory is always promoted between solves."""
        verbose = self.options.verbose if verbose is None else verbose
        if verbose:
            solver_info()
        if warm_start and self._duals is not None:
            if self._warm_solve_fn is None:
                self._warm_solve_fn = make_solve_fn(
                    self.spec, self.options, self._callback,
                    dual_warm_start=True, device=self.device)
            sol = self._warm_solve_fn(self._xs, self._us, self._ws,
                                      self._duals, self._penalty)
        else:
            sol = self._solve_fn(self._xs, self._us, self._ws)
        self.solution = sol
        # promote the solved nominal and AL state for later warm solves
        self._xs, self._us = sol.xs, sol.us
        self._duals, self._penalty = sol.duals, sol.penalty
        if verbose:
            print_solution(sol)
        return sol

    def warm_solve(self, verbose: Optional[bool] = None) -> Solution:
        """``solve(warm_start=True)``: a cold solve when no solution exists."""
        return self.solve(verbose=verbose, warm_start=True)

    def reset_duals(self):
        """Drop the retained duals and penalties: the next solve starts the
        AL state cold."""
        self._duals = None
        self._penalty = None
        return self

    # -- accessors ------------------------------------------------------------

    def get_trajectory(self):
        """Nominal trajectory as per-timestep lists of tensors trimmed to
        the true dims."""
        xs, us = ((self._xs, self._us) if self.solution is None
                  else (self.solution.xs, self.solution.us))
        x_list = [xs[t, : int(self.spec.x_dims[t])] for t in range(self.spec.T)]
        u_list = [us[t, : int(self.spec.u_dims[t])] for t in range(self.spec.T - 1)]
        return x_list, u_list

    def current_trajectory(self):
        """After a solve the current and nominal trajectories coincide."""
        return self.get_trajectory()

    @property
    def parameters(self):
        return self._ws

    @parameters.setter
    def parameters(self, ws):
        self._ws = torch.as_tensor(ws, dtype=self.dtype, device=self.device)
