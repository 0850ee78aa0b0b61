"""The comparison that decides ``correct``.

Every answer the window produced is held to the plain reference, worked
out again from the inputs the benchmark made, in float64:

* ``start_gap``: a plan's first state against the batch's x0; exact;
* ``dynamics_gap``: each next state against the reference's RK2 step from
  the returned state and control, relative to 1 + |x|, over the lanes the
  program reports a successful step for or the reference holds solved;
* ``objective_gap``: the returned augmented objective against the
  reference's cost plus AL terms at the returned trajectory, duals and
  penalties, relative to 1 + |J|, over the same lanes;
* ``gain_gap``: the returned feedback and feedforward gains against the
  Riccati recursion of the frozen NumPy oracle (its complex-step
  Jacobians, AL augmentation and backward pass) at the returned
  trajectory, duals, penalties and regularization, on lanes drawn from
  the seed, each relative to max(1, its largest entry);
* ``unsolved_share``: the share of answers whose reference violation
  passes the configuration's constraint tolerance (which instances count
  as solved is the reference's, never the solver's own flag).

The control (``control_answers``) puts the reference in the program's
place at TF32 precision, the nearest below the float32 the
configurations state: the program's states and controls rounded to 10
mantissa bits (one rounding each, not TF32 error carried through a
rollout), the objective worked out at them and rounded, the gains from
the recursion with every stack and intermediate result rounded.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import numpy_reference as nr


def tf32(x):
    """``x`` rounded to TF32 (8 exponent and 10 mantissa bits), nearest,
    ties away from zero, in ``x``'s dtype."""
    f = x.to(torch.float32).contiguous()
    i = f.view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32).to(x.dtype)


class Answers:
    """What the comparison reads of one batch: every field
    batch-leading, on the run's device; the gains only on the lanes
    ``gain_lanes`` that their check samples."""

    FIELDS = ("xs", "us", "objective", "status", "duals", "penalty", "reg", "gain_lanes", "K",
              "k")

    def __init__(self, **kw):
        for f in self.FIELDS:
            setattr(self, f, kw[f])

    @classmethod
    def of(cls, sol, gain_lanes):
        """The fields of a Solution, its gains cut to ``gain_lanes``."""
        kept = {f: getattr(sol, f) for f in cls.FIELDS[:7]}
        return cls(**kept, gain_lanes=gain_lanes, K=sol.K[gain_lanes], k=sol.k[gain_lanes])


def violations(ref, xs, us):
    """(the reference's max violation a lane, constraint values)."""
    c = ref.constraints(xs, us)
    ineq, cmask = ref.ineq.to(c.device), ref.cmask.to(c.device)
    v = torch.where(ineq, torch.clamp(c, min=0.0), c.abs())
    v = torch.where(cmask, v, torch.zeros_like(v)).amax(dim=(-1, -2))
    return v, c


def objective(ref, xs, us, c, duals, penalty):
    """The reference's augmented objective a lane: cost plus, over the
    rows that exist, lambda c + rho c^2 / 2 (inequality rows with c < 0 and
    lambda = 0 inactive)."""
    lam, rho = duals.to(xs.dtype), penalty.to(xs.dtype)
    ineq, cmask = ref.ineq.to(c.device), ref.cmask.to(c.device)
    active = ~(ineq & (c < 0.0) & (lam == 0.0))
    al = torch.where(cmask, lam * c + 0.5 * active * rho * c * c, torch.zeros_like(c))
    return ref.cost(xs, us) + al.sum(dim=(-1, -2))


def trajectory_numbers(ref, tol, start, a: Answers) -> dict:
    """Every number but the gains' for one batch of answers, and the
    reference's count of solved instances."""
    f64 = torch.float64
    xs, us = a.xs.to(f64), a.us.to(f64)
    start_gap = (xs[:, 0] - start.to(f64)).abs().amax()
    v, c = violations(ref, xs, us)
    solved = v <= tol
    checked = a.status.to(torch.bool) | solved
    nxt = ref.discrete(xs[:, :-1], us)
    dyn = ((xs[:, 1:] - nxt).abs().amax(-1) / (1.0 + xs[:, 1:].abs().amax(-1))).amax(-1)
    J = objective(ref, xs, us, c, a.duals, a.penalty)
    obj = (a.objective.to(f64) - J).abs() / (1.0 + J.abs())
    none = xs.new_zeros(())
    return {
        "start_gap": float(start_gap),
        "dynamics_gap": float(torch.where(checked, dyn, none).amax()),
        "objective_gap": float(torch.where(checked, obj, none).amax()),
        "solved": int(solved.sum()),
        "attempted": int(solved.numel()),
    }


def oracle(config):
    twin = config["reference"]
    return getattr(nr, twin["numpy_twin"])(config["T"], **twin.get("kwargs", {}))[0]


def oracle_stacks(prob, cmask, xs, us, duals, penalty):
    """The oracle's derivative stacks at a trajectory, duals and penalties:
    complex-step dynamics Jacobians and its AL-augmented cost terms."""
    lams = [duals[t][cmask[t]] for t in range(prob.T)]
    rhos = [penalty[t][cmask[t]] for t in range(prob.T)]
    return prob.fjac(xs, us) + tuple(nr._al_derivs(prob, xs, us, lams, rhos))


def recursion(stacks, reg, options, rnd=None):
    """(K, k) of the oracle's Riccati recursion (``numpy_reference.
    _backward_pass``'s steps) on ``stacks``, the regularization retried as
    the program does (times its scale, clamped) where Quu + reg I has no
    Cholesky factor; None where no attempt factors.  ``rnd`` rounds every
    stack and every intermediate result (the control's TF32)."""
    o = options
    r = rnd or (lambda v: v)
    stacks = tuple(r(s) for s in stacks)
    for _ in range(o["max_regularization_steps"] + 1):
        out = _recursion(*stacks, reg, r)
        if out is not None:
            return out
        reg = min(max(reg * o["regularization_scale"], o["regularization_min"]),
                  o["regularization_max"])
    return None


def _recursion(fx, fu, gx, gu, gxx, guu, gux, reg, r):
    Tm1, m = fu.shape[0], fu.shape[2]
    K, k = np.zeros((Tm1, m, fx.shape[1])), np.zeros((Tm1, m))
    P, p = gxx[-1], gx[-1]
    for t in range(Tm1 - 1, -1, -1):
        A, B = fx[t], fu[t]
        Qx = r(gx[t] + r(A.T @ p))
        Qu = r(gu[t] + r(B.T @ p))
        BtP = r(B.T @ P)
        Qxx = r(gxx[t] + r(r(A.T @ P) @ A))
        Quu = r(guu[t] + r(BtP @ B))
        Qux = r(gux[t] + r(BtP @ A))
        Quu_r = r(Quu + reg * np.eye(m))
        try:
            np.linalg.cholesky(Quu_r)
        except np.linalg.LinAlgError:
            return None
        Kt = r(-np.linalg.solve(Quu_r, Qux))
        kt = r(-np.linalg.solve(Quu_r, Qu))
        K[t], k[t] = Kt, kt
        QuuK = r(Quu @ Kt)
        P = r(r(r(Qxx + r(Kt.T @ QuuK)) + r(Kt.T @ Qux)) + r(Qux.T @ Kt))
        P = r(0.5 * (P + P.T))
        p = r(r(r(Qx + r(QuuK.T @ kt)) + r(Kt.T @ Qu)) + r(Qux.T @ kt))
    return K, k


def gains_number(config, ref, a: Answers, control: bool = False) -> float:
    """The widest gap over the sampled lanes of one batch between the
    returned gains (with ``control``, the recursion's at TF32) and the
    float64 recursion's, each of K and k relative to max(1, its largest
    entry)."""
    prob, cmask, o = oracle(config), ref.cmask.numpy(), config["options"]
    lanes = a.gain_lanes
    host = lambda t: t.detach().to("cpu", torch.float64).numpy()
    xs, us, duals, penalty, reg = (host(t[lanes]) for t in (a.xs, a.us, a.duals, a.penalty, a.reg))
    K, k = host(a.K), host(a.k)
    worst = 0.0
    for i in range(len(lanes)):
        stacks = oracle_stacks(prob, cmask, xs[i], us[i], duals[i], penalty[i])
        want = recursion(stacks, float(reg[i]), o)
        got = recursion(stacks, float(reg[i]), o, tf32_np) if control else (K[i], k[i])
        if want is None or got is None:
            return float("inf")
        gap = max(np.abs(g - w).max() / max(1.0, np.abs(w).max()) for g, w in zip(got, want))
        worst = max(worst, float(gap) if np.isfinite(gap) else float("inf"))
    return worst


def control_answers(ref, a: Answers) -> Answers:
    """The reference in the program's place at TF32: the answer's states
    and controls held at TF32 (the start state with them), its objective
    worked out at those and rounded to TF32; its gains are
    ``gains_number(control=True)``'s."""
    f64 = torch.float64
    xs, us = tf32(a.xs.to(f64)), tf32(a.us.to(f64))
    c = ref.constraints(xs, us)
    J = objective(ref, xs, us, c, a.duals, a.penalty)
    return Answers(xs=xs, us=us, objective=tf32(J), status=a.status, duals=a.duals,
                   penalty=a.penalty, reg=a.reg, gain_lanes=a.gain_lanes, K=a.K, k=a.k)


def tf32_np(a):
    return tf32(torch.as_tensor(np.asarray(a, dtype=np.float64))).numpy()
