# Frozen copy of benchmarks/numpy_reference.py as of commit 4e1ef66, the
# benchmark's plain NumPy oracle.  Everything below this header is that file
# unchanged; the benchmark never reads benchmarks/ and this copy imports
# nothing but numpy.
"""Sequential single-core NumPy AL-iLQR: the self-measured baseline stand-in.

The reference (thowell/IterativeLQR.jl) publishes no benchmark numbers
(BASELINE.md) and Julia is not installed in this image, so the baseline
protocol runs *this* implementation: the same algorithm as the reference —
sequential backward Riccati recursion with Cholesky (src/backward_pass.jl:
42-90), serial Armijo backtracking on closed-loop rollouts
(src/forward_pass.jl:26-54), augmented-Lagrangian outer loop with dual ascent
and geometric penalty scaling (src/augmented_lagrangian.jl:87-110,
src/solve.jl:88-129) — in double precision on one CPU core, with
vectorized-over-horizon derivative stacks standing in for the reference's
compiled Symbolics.jl kernels.

It deliberately does NOT replicate the reference's quirks (Hessian
accumulation across iterations, unchecked Cholesky — SURVEY.md "quirks"), so
it also serves as an independent correctness oracle for trajectory-parity
tests (tests/test_reference_parity.py).

Derivatives: complex-step differentiation (machine-precision, vectorized over
the horizon) for dynamics; analytic closed forms for the quadratic costs and
constraint blocks of the three reference problems.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Generic problem container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NpProblem:
    """Sequential-solver problem: callables operate on numpy arrays.

    f           : (x [n], u [m]) -> x' [n]                  single step
    fjac        : (xs [T,n], us [T-1,m]) -> (fx [T-1,n,n], fu [T-1,n,m])
    cost        : (xs, us) -> float
    cost_derivs : (xs, us) -> (gx [T,n], gu [T-1,m],
                               gxx [T,n,n], guu [T-1,m,m], gux [T-1,m,n])
    con         : (xs, us) -> list of T arrays c_t [nc_t]   (may be empty)
    cjac        : (xs, us) -> list of T (cx_t [nc_t,n], cu_t [nc_t,m])
    ineq        : list of T boolean arrays [nc_t]
    """

    T: int
    n: int
    m: int
    f: Callable
    fjac: Callable
    cost: Callable
    cost_derivs: Callable
    con: Optional[Callable] = None
    cjac: Optional[Callable] = None
    ineq: Optional[List[np.ndarray]] = None


def complex_step_fjac(f_vec: Callable, n: int, m: int):
    """Build a vectorized-over-horizon dynamics Jacobian via complex step.

    ``f_vec`` must accept stacked complex inputs (xs [K,n], us [K,m]) ->
    [K,n].  Complex-step gives derivatives to machine precision:
    d f / d z_j = Im f(z + i h e_j) / h.
    """
    h = 1e-200

    def fjac(xs, us):
        Tm1 = us.shape[0]
        X = np.repeat(xs[:-1, None, :], n + m, axis=1).astype(complex)  # [T-1,n+m,n]
        U = np.repeat(us[:, None, :], n + m, axis=1).astype(complex)
        for j in range(n):
            X[:, j, j] += 1j * h
        for j in range(m):
            U[:, n + j, j] += 1j * h
        Y = f_vec(X.reshape(-1, n), U.reshape(-1, m)).reshape(Tm1, n + m, n)
        J = Y.imag / h  # [T-1, n+m, n]; J[t, j, :] = df/dz_j
        fx = np.swapaxes(J[:, :n, :], 1, 2)
        fu = np.swapaxes(J[:, n:, :], 1, 2)
        return fx, fu

    return fjac


# ---------------------------------------------------------------------------
# Options (reference defaults: src/options.jl:1-14)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NpOptions:
    max_iterations: int = 100
    max_dual_updates: int = 10
    min_step_size: float = 1.0e-5
    objective_tolerance: float = 1.0e-3
    lagrangian_gradient_tolerance: float = 1.0e-3
    constraint_tolerance: float = 5.0e-3
    initial_constraint_penalty: float = 1.0
    scaling_penalty: float = 10.0
    max_penalty: float = 1.0e8
    armijo_c1: float = 1.0e-4
    max_line_search_iterations: int = 25


# ---------------------------------------------------------------------------
# AL machinery (reference: src/augmented_lagrangian.jl)
# ---------------------------------------------------------------------------


def _active(c, lam, ineq):
    inactive = ineq & (c < 0.0) & (lam == 0.0)
    return np.where(inactive, 0.0, 1.0)


def _al_cost(cs, lams, rhos, ineqs):
    total = 0.0
    for c, lam, rho, ineq in zip(cs, lams, rhos, ineqs):
        if c.size == 0:
            continue
        a = _active(c, lam, ineq)
        total += lam @ c + 0.5 * np.sum(a * rho * c * c)
    return total


def _max_violation(cs, ineqs):
    v = 0.0
    for c, ineq in zip(cs, ineqs):
        if c.size == 0:
            continue
        vi = np.where(ineq, np.maximum(c, 0.0), np.abs(c))
        v = max(v, float(vi.max()))
    return v


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


def _backward_pass(fx, fu, gx, gu, gxx, guu, gux, reg):
    """Sequential Riccati recursion (reference: src/backward_pass.jl:42-90),
    with a regularized retry instead of the reference's unchecked potrf."""
    Tm1, n, m = fu.shape[0], fu.shape[1], fu.shape[2]
    K = np.zeros((Tm1, m, n))
    kff = np.zeros((Tm1, m))
    Qx_all = np.zeros((Tm1, n))
    Qu_all = np.zeros((Tm1, m))
    p_all = np.zeros((Tm1, n))
    P, p = gxx[-1], gx[-1]
    for t in range(Tm1 - 1, -1, -1):
        A, B = fx[t], fu[t]
        Qx = gx[t] + A.T @ p
        Qu = gu[t] + B.T @ p
        BtP = B.T @ P
        Qxx = gxx[t] + A.T @ P @ A
        Quu = guu[t] + BtP @ B
        Qux = gux[t] + BtP @ A
        Quu_r = Quu + reg * np.eye(m)
        try:
            L = np.linalg.cholesky(Quu_r)
        except np.linalg.LinAlgError:
            return None  # signal: escalate regularization
        Kt = -np.linalg.solve(Quu_r, Qux)
        kt = -np.linalg.solve(Quu_r, Qu)
        K[t], kff[t] = Kt, kt
        QuuK = Quu @ Kt
        P = Qxx + Kt.T @ QuuK + Kt.T @ Qux + Qux.T @ Kt
        P = 0.5 * (P + P.T)
        p_new = Qx + QuuK.T @ kt + Kt.T @ Qu + Qux.T @ kt
        Qx_all[t], Qu_all[t], p_all[t] = Qx, Qu, p
        p = p_new
    return K, kff, Qx_all, Qu_all, p_all


def _rollout(prob, xbar, ubar, K, kff, alpha):
    xs = np.zeros_like(xbar)
    us = np.zeros_like(ubar)
    xs[0] = xbar[0]
    for t in range(prob.T - 1):
        us[t] = ubar[t] + K[t] @ (xs[t] - xbar[t]) + alpha * kff[t]
        xs[t + 1] = prob.f(xs[t], us[t])
    return xs, us


def _al_derivs(prob, xs, us, lams, rhos):
    gx, gu, gxx, guu, gux = prob.cost_derivs(xs, us)
    gx, gu = gx.copy(), gu.copy()
    gxx, guu, gux = gxx.copy(), guu.copy(), gux.copy()
    if prob.con is not None:
        cs = prob.con(xs, us)
        jacs = prob.cjac(xs, us)
        for t in range(prob.T):
            c = cs[t]
            if c.size == 0:
                continue
            cx, cu = jacs[t]
            a = _active(c, lams[t], prob.ineq[t])
            irho = rhos[t] * a
            w = lams[t] + irho * c
            gx[t] += cx.T @ w
            gxx[t] += cx.T @ (irho[:, None] * cx)
            if t < prob.T - 1:
                gu[t] += cu.T @ w
                guu[t] += cu.T @ (irho[:, None] * cu)
                gux[t] += cu.T @ (irho[:, None] * cx)
    return gx, gu, gxx, guu, gux


def _ilqr(prob, xs, us, lams, rhos, opts):
    def total(xs_, us_):
        J = prob.cost(xs_, us_)
        cs = prob.con(xs_, us_) if prob.con is not None else None
        if cs is not None:
            J += _al_cost(cs, lams, rhos, prob.ineq)
        return J, cs

    J, cs = total(xs, us)
    iters = 0
    for _ in range(opts.max_iterations):
        fx, fu = prob.fjac(xs, us)
        gx, gu, gxx, guu, gux = _al_derivs(prob, xs, us, lams, rhos)
        reg, bp = 0.0, None
        while bp is None and reg < 1e12:
            bp = _backward_pass(fx, fu, gx, gu, gxx, guu, gux, reg)
            if bp is None:
                reg = max(reg * 10.0, 1e-6)
        K, kff, Qx, Qu, p = bp

        # Armijo slope via closed-loop trajectory sensitivities
        # (reference: src/data/methods.jl:42-54, src/forward_pass.jl:18-23)
        zx = np.zeros(prob.n)
        slope = 0.0
        for t in range(prob.T - 1):
            zu = kff[t] + K[t] @ zx
            slope += (Qx[t] - p[t]) @ zx + Qu[t] @ zu
            zx = fx[t] @ zx + fu[t] @ zu

        alpha, accepted = 1.0, False
        for _ls in range(opts.max_line_search_iterations):
            # probe trajectories at large alpha can diverge; the resulting
            # inf/nan cost is rejected by the isfinite check below, so the
            # overflow warnings are noise
            with np.errstate(over="ignore", invalid="ignore"):
                xs_c, us_c = _rollout(prob, xs, us, K, kff, alpha)
                J_c, cs_c = total(xs_c, us_c)
            if np.isfinite(J_c) and J_c <= J + opts.armijo_c1 * alpha * slope:
                accepted = True
                break
            alpha *= 0.5
            if alpha < opts.min_step_size:
                break
        iters += 1
        if not accepted:
            break
        dJ = abs(J - J_c)
        xs, us, J, cs = xs_c, us_c, J_c, cs_c

        # gradient norm at the new point
        fx, fu = prob.fjac(xs, us)
        gx, gu, gxx, guu, gux = _al_derivs(prob, xs, us, lams, rhos)
        bp = _backward_pass(fx, fu, gx, gu, gxx, guu, gux, 0.0)
        if bp is None:
            bp = _backward_pass(fx, fu, gx, gu, gxx, guu, gux, 1e-6)
        if bp is not None:
            _, _, Qx, Qu, p = bp
            gnorm = max(np.abs(Qx - p).max(), np.abs(Qu).max())
            if gnorm < opts.lagrangian_gradient_tolerance:
                break
        if dJ < opts.objective_tolerance:
            break
    return xs, us, J, cs, iters


def solve(prob: NpProblem, xs, us, opts: NpOptions = NpOptions()):
    """Constrained AL-iLQR solve (reference: src/solve.jl:88-129).

    Returns (xs, us, info dict)."""
    xs = np.array(xs, dtype=float)
    us = np.array(us, dtype=float)
    lams = [np.zeros(len(i)) for i in prob.ineq] if prob.ineq else None
    rhos = (
        [np.full(len(i), opts.initial_constraint_penalty) for i in prob.ineq]
        if prob.ineq
        else None
    )
    total_iters, al_iters, viol = 0, 0, 0.0
    for _ in range(opts.max_dual_updates):
        xs, us, J, cs, it = _ilqr(prob, xs, us, lams, rhos, opts)
        total_iters += it
        al_iters += 1
        if cs is None:
            break
        viol = _max_violation(cs, prob.ineq)
        if viol <= opts.constraint_tolerance:
            break
        for t in range(prob.T):
            c = cs[t]
            if c.size == 0:
                continue
            lams[t] = lams[t] + rhos[t] * c
            lams[t] = np.where(prob.ineq[t], np.maximum(lams[t], 0.0), lams[t])
            rhos[t] = np.minimum(opts.scaling_penalty * rhos[t], opts.max_penalty)
    return xs, us, {
        "iterations": total_iters,
        "al_iterations": al_iters,
        "max_violation": viol,
        "objective": float(prob.cost(xs, us)),
    }


# ---------------------------------------------------------------------------
# Model adapters (numpy twins of iterativelqr_tpu/models/*)
# ---------------------------------------------------------------------------


def acrobot_problem(T: int = 101) -> Tuple[NpProblem, np.ndarray, np.ndarray]:
    """Acrobot swing-up, numpy twin of models/acrobot.py (examples/acrobot.jl)."""
    m1, m2, I1, I2 = 1.0, 1.0, 0.33, 0.33
    L1, lc1, lc2 = 1.0, 0.5, 0.5
    g, mu1, mu2 = 9.81, 0.1, 0.1
    h = 0.1
    n, m = 4, 1
    xT = np.array([np.pi, 0.0, 0.0, 0.0])

    def fc(x, u):
        # vectorized over leading axes; works for real and complex dtypes
        q1, q2, v1, v2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        a = I1 + I2 + m2 * L1**2 + 2.0 * m2 * L1 * lc2 * np.cos(q2)
        b = I2 + m2 * L1 * lc2 * np.cos(q2)
        c = I2
        det = a * c - b * b
        tau1 = -m1 * g * lc1 * np.sin(q1) - m2 * g * (
            L1 * np.sin(q1) + lc2 * np.sin(q1 + q2)
        )
        tau2 = -m2 * g * lc2 * np.sin(q1 + q2)
        c11 = -2.0 * m2 * L1 * lc2 * np.sin(q2) * v2
        c12 = -m2 * L1 * lc2 * np.sin(q2) * v2
        c21 = m2 * L1 * lc2 * np.sin(q2) * v1
        rhs1 = -(c11 * v1 + c12 * v2) + tau1 - mu1 * v1
        rhs2 = -(c21 * v1) + tau2 + u[..., 0] - mu2 * v2
        qdd1 = (c * rhs1 - b * rhs2) / det
        qdd2 = (-b * rhs1 + a * rhs2) / det
        return np.stack([v1, v2, qdd1, qdd2], axis=-1)

    def fd(x, u):
        return x + h * fc(x + 0.5 * h * fc(x, u), u)

    fjac = complex_step_fjac(fd, n, m)

    def cost(xs, us):
        return 0.1 * float(
            (xs[:, 2:4] ** 2).sum() + (us**2).sum()
        )

    def cost_derivs(xs, us):
        T_ = xs.shape[0]
        gx = np.zeros((T_, n))
        gx[:, 2:4] = 0.2 * xs[:, 2:4]
        gu = 0.2 * us
        gxx = np.zeros((T_, n, n))
        gxx[:, 2, 2] = 0.2
        gxx[:, 3, 3] = 0.2
        guu = np.broadcast_to(0.2 * np.eye(m), (T_ - 1, m, m)).copy()
        gux = np.zeros((T_ - 1, m, n))
        return gx, gu, gxx, guu, gux

    def con(xs, us):
        cs = [np.zeros(0) for _ in range(T - 1)]
        cs.append(xs[-1] - xT)
        return cs

    def cjac(xs, us):
        jacs = [(np.zeros((0, n)), np.zeros((0, m))) for _ in range(T - 1)]
        jacs.append((np.eye(n), np.zeros((n, m))))
        return jacs

    ineq = [np.zeros(0, bool) for _ in range(T - 1)] + [np.zeros(n, bool)]
    prob = NpProblem(T, n, m, lambda x, u: fd(x, u), fjac, cost, cost_derivs,
                     con, cjac, ineq)
    return prob, np.zeros(n), xT


def particle_problem(T: int = 11) -> Tuple[NpProblem, np.ndarray, np.ndarray]:
    n, m = 2, 1
    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0], [1.0]])
    xT = np.array([1.0, 0.0])

    def fd(x, u):
        return x @ A.T + u @ B.T if x.ndim > 1 else A @ x + B[:, 0] * u[0]

    def fjac(xs, us):
        Tm1 = us.shape[0]
        return (
            np.broadcast_to(A, (Tm1, n, n)).copy(),
            np.broadcast_to(B, (Tm1, n, m)).copy(),
        )

    def cost(xs, us):
        return 0.1 * float((xs**2).sum() + (us**2).sum())

    def cost_derivs(xs, us):
        T_ = xs.shape[0]
        gx = 0.2 * xs
        gu = 0.2 * us
        gxx = np.broadcast_to(0.2 * np.eye(n), (T_, n, n)).copy()
        guu = np.broadcast_to(0.2 * np.eye(m), (T_ - 1, m, m)).copy()
        gux = np.zeros((T_ - 1, m, n))
        return gx, gu, gxx, guu, gux

    def con(xs, us):
        return [np.zeros(0) for _ in range(T - 1)] + [xs[-1] - xT]

    def cjac(xs, us):
        return [(np.zeros((0, n)), np.zeros((0, m))) for _ in range(T - 1)] + [
            (np.eye(n), np.zeros((n, m)))
        ]

    ineq = [np.zeros(0, bool) for _ in range(T - 1)] + [np.zeros(n, bool)]
    prob = NpProblem(T, n, m, fd, fjac, cost, cost_derivs, con, cjac, ineq)
    return prob, np.zeros(n), xT


def car_problem(T: int = 51) -> Tuple[NpProblem, np.ndarray, np.ndarray]:
    n, m = 3, 2
    h = 0.1
    xT = np.array([1.0, 1.0, 0.0])
    p_obs = np.array([0.5, 0.5])
    r_obs = 0.1
    ul, uu = -5.0, 5.0

    def fc(x, u):
        th = x[..., 2]
        return np.stack(
            [u[..., 0] * np.cos(th), u[..., 0] * np.sin(th), u[..., 1]], axis=-1
        )

    def fd(x, u):
        return x + h * fc(x + 0.5 * h * fc(x, u), u)

    fjac = complex_step_fjac(fd, n, m)

    def cost(xs, us):
        e = xs - xT
        return float((e[:-1] ** 2).sum() + 1e-2 * (us**2).sum()
                     + 1000.0 * (e[-1] ** 2).sum())

    def cost_derivs(xs, us):
        T_ = xs.shape[0]
        e = xs - xT
        gx = 2.0 * e
        gx[-1] = 2000.0 * e[-1]
        gu = 2e-2 * us
        gxx = np.broadcast_to(2.0 * np.eye(n), (T_, n, n)).copy()
        gxx[-1] = 2000.0 * np.eye(n)
        guu = np.broadcast_to(2e-2 * np.eye(m), (T_ - 1, m, m)).copy()
        gux = np.zeros((T_ - 1, m, n))
        return gx, gu, gxx, guu, gux

    def con(xs, us):
        cs = []
        for t in range(T - 1):
            e = xs[t, :2] - p_obs
            cs.append(
                np.concatenate(
                    [ul - us[t], us[t] - uu, [r_obs**2 - e @ e]]
                )
            )
        e = xs[-1, :2] - p_obs
        cs.append(np.concatenate([xs[-1] - xT, [r_obs**2 - e @ e]]))
        return cs

    def cjac(xs, us):
        jacs = []
        for t in range(T - 1):
            cx = np.zeros((5, n))
            cx[4, :2] = -2.0 * (xs[t, :2] - p_obs)
            cu = np.zeros((5, m))
            cu[:2] = -np.eye(m)
            cu[2:4] = np.eye(m)
            jacs.append((cx, cu))
        cx = np.zeros((4, n))
        cx[:3] = np.eye(n)
        cx[3, :2] = -2.0 * (xs[-1, :2] - p_obs)
        jacs.append((cx, np.zeros((4, m))))
        return jacs

    ineq = [np.ones(5, bool) for _ in range(T - 1)] + [
        np.array([False, False, False, True])
    ]
    prob = NpProblem(T, n, m, fd, fjac, cost, cost_derivs, con, cjac, ineq)
    return prob, np.zeros(n), xT


def cartpole_problem(
    T: int = 101, u_limit: float = 10.0, shaping_weight: float = 5.0
) -> Tuple[NpProblem, np.ndarray, np.ndarray]:
    """Cartpole swing-up, numpy twin of models/cartpole.py (control-limit
    inequalities + wrapped terminal-angle equality)."""
    mc, mp, length, g = 1.0, 0.2, 0.5, 9.81
    h = 0.05
    n, m = 4, 1
    xT = np.array([0.0, np.pi, 0.0, 0.0])

    def fc(x, u):
        th, xd, thd = x[..., 1], x[..., 2], x[..., 3]
        f = u[..., 0]
        s, c = np.sin(th), np.cos(th)
        total = mc + mp
        tmp = (f + mp * length * thd**2 * s) / total
        thdd = (g * s - c * tmp) / (length * (4.0 / 3.0 - mp * c**2 / total))
        xdd = tmp - mp * length * thdd * c / total
        return np.stack([xd, thd, xdd, thdd], axis=-1)

    def fd(x, u):
        return x + h * fc(x + 0.5 * h * fc(x, u), u)

    fjac = complex_step_fjac(fd, n, m)

    def cost(xs, us):
        return float(
            0.01 * (us**2).sum()
            + 0.1 * (xs[:, 2:] ** 2).sum()
            + shaping_weight * (1.0 + np.cos(xs[:-1, 1])).sum()
            + 0.1 * (xs[:-1, 0] ** 2).sum()
        )

    def cost_derivs(xs, us):
        T_ = xs.shape[0]
        gx = np.zeros((T_, n))
        gx[:, 2:] = 0.2 * xs[:, 2:]
        gx[:-1, 1] = -shaping_weight * np.sin(xs[:-1, 1])
        gx[:-1, 0] = 0.2 * xs[:-1, 0]
        gu = 0.02 * us
        gxx = np.zeros((T_, n, n))
        gxx[:, 2, 2] = 0.2
        gxx[:, 3, 3] = 0.2
        gxx[:-1, 1, 1] = -shaping_weight * np.cos(xs[:-1, 1])
        gxx[:-1, 0, 0] = 0.2
        guu = np.broadcast_to(0.02 * np.eye(m), (T_ - 1, m, m)).copy()
        gux = np.zeros((T_ - 1, m, n))
        return gx, gu, gxx, guu, gux

    def con(xs, us):
        cs = [
            np.array([-u_limit - us[t, 0], us[t, 0] - u_limit])
            for t in range(T - 1)
        ]
        th = xs[-1, 1]
        cs.append(
            np.array([xs[-1, 0], np.sin((th - np.pi) / 2.0),
                      xs[-1, 2], xs[-1, 3]])
        )
        return cs

    def cjac(xs, us):
        jacs = []
        for _ in range(T - 1):
            cx = np.zeros((2, n))
            cu = np.array([[-1.0], [1.0]])
            jacs.append((cx, cu))
        cx = np.zeros((4, n))
        cx[0, 0] = 1.0
        cx[1, 1] = 0.5 * np.cos((xs[-1, 1] - np.pi) / 2.0)
        cx[2, 2] = 1.0
        cx[3, 3] = 1.0
        jacs.append((cx, np.zeros((4, m))))
        return jacs

    ineq = [np.ones(2, bool) for _ in range(T - 1)] + [np.zeros(4, bool)]
    prob = NpProblem(T, n, m, fd, fjac, cost, cost_derivs, con, cjac, ineq)
    return prob, np.zeros(n), xT


def quadrotor_problem(
    T: int = 41, goal=(1.0, 1.0, 1.0), u_min: float = 0.0, u_max: float = 6.0
) -> Tuple[NpProblem, np.ndarray, np.ndarray]:
    """Quadrotor waypoint flight, numpy twin of models/quadrotor.py (12
    states / 4 controls; rotor-thrust bounds + terminal hover equality)."""
    mass, g, arm, kt = 1.0, 9.81, 0.2, 0.02
    inertia = np.array([0.01, 0.01, 0.02])
    h = 0.05
    n, m = 12, 4
    xT = np.zeros(n)
    xT[0:3] = np.asarray(goal)
    hover = mass * g / 4.0

    def fc(x, u):
        v = x[..., 6:9]
        w = x[..., 9:12]
        roll, pitch = x[..., 3], x[..., 4]
        yaw = x[..., 5]
        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cy, sy = np.cos(yaw), np.sin(yaw)
        thrust = u.sum(axis=-1)
        bz = np.stack(
            [cy * sp * cr + sy * sr, sy * sp * cr - cy * sr, cp * cr],
            axis=-1,
        )
        gvec = np.zeros(3)
        gvec[2] = g
        acc = bz * (thrust / mass)[..., None] - gvec
        tau = np.stack(
            [
                arm * (u[..., 1] - u[..., 3]),
                arm * (u[..., 2] - u[..., 0]),
                kt * (u[..., 0] - u[..., 1] + u[..., 2] - u[..., 3]),
            ],
            axis=-1,
        )
        wdot = (tau - np.cross(w, inertia * w)) / inertia
        t_pitch = np.tan(pitch)
        angdot = np.stack(
            [
                w[..., 0] + sr * t_pitch * w[..., 1] + cr * t_pitch * w[..., 2],
                cr * w[..., 1] - sr * w[..., 2],
                (sr * w[..., 1] + cr * w[..., 2]) / cp,
            ],
            axis=-1,
        )
        return np.concatenate([v, angdot, acc, wdot], axis=-1)

    def fd(x, u):
        return x + h * fc(x + 0.5 * h * fc(x, u), u)

    fjac = complex_step_fjac(fd, n, m)
    Wx = np.diag([1.0] * 3 + [0.5] * 3 + [0.1] * 6)

    def cost(xs, us):
        e = xs - xT
        du = us - hover
        stage = (e[:-1] @ Wx * e[:-1]).sum() + 0.05 * (du**2).sum()
        return float(stage + (e[-1] ** 2).sum())

    def cost_derivs(xs, us):
        T_ = xs.shape[0]
        e = xs - xT
        gx = 2.0 * e @ Wx
        gx[-1] = 2.0 * e[-1]
        gu = 0.1 * (us - hover)
        gxx = np.broadcast_to(2.0 * Wx, (T_, n, n)).copy()
        gxx[-1] = 2.0 * np.eye(n)
        guu = np.broadcast_to(0.1 * np.eye(m), (T_ - 1, m, m)).copy()
        gux = np.zeros((T_ - 1, m, n))
        return gx, gu, gxx, guu, gux

    def con(xs, us):
        cs = [
            np.concatenate([u_min - us[t], us[t] - u_max])
            for t in range(T - 1)
        ]
        cs.append(xs[-1] - xT)
        return cs

    def cjac(xs, us):
        cu = np.concatenate([-np.eye(m), np.eye(m)], axis=0)
        jacs = [(np.zeros((2 * m, n)), cu) for _ in range(T - 1)]
        jacs.append((np.eye(n), np.zeros((n, m))))
        return jacs

    ineq = [np.ones(2 * m, bool) for _ in range(T - 1)] + [np.zeros(n, bool)]
    prob = NpProblem(T, n, m, fd, fjac, cost, cost_derivs, con, cjac, ineq)
    return prob, np.zeros(n), xT
