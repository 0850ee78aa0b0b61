"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: here they skip when torch finds no card.  On a machine with
a card and without JAX (which tests/conftest.py imports), run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

This file imports torch and numpy only.
"""

import numpy as np
import pytest
import torch
import iterativelqr_tpu_torch as P
from torch_user_problems import (acrobot_lambdas, car_user, demo_problem, farm_problem,
                                 padded_actionless, padded_lift_project, quadrotor_matrix,
                                 quadrotor_team, team_starts)

from iterativelqr_tpu_torch import Constraint, Cost, Options, build_spec
from iterativelqr_tpu_torch.models import acrobot, car, cartpole, particle, pendulum, quadrotor
from iterativelqr_tpu_torch.ops import packed_backward as pk
from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk


def _stacks(rng, B, Tm1, n, m):
    """Well-conditioned batch-last derivative stacks (numpy, f64)."""
    T = Tm1 + 1
    fx = 0.1 * rng.standard_normal((Tm1, n, n, B)) + np.eye(n)[None, :, :, None]
    fu = 0.1 * rng.standard_normal((Tm1, n, m, B))
    gx = rng.standard_normal((T, n, B))
    gu = rng.standard_normal((Tm1, m, B))
    A = rng.standard_normal((T, n, n, B))
    gxx = np.einsum("tikb,tjkb->tijb", A, A) / n + 0.1 * np.eye(n)[None, :, :, None]
    guu = 0.1 + np.abs(rng.standard_normal((Tm1, m, m, B)))
    gux = 0.05 * rng.standard_normal((Tm1, m, n, B))
    return [fx, fu, gx, gu, gxx, guu, gux]


def _assert_close_scaled(out, ref, tol):
    """Every output within tol relative to its largest value (NaN where the
    plain version has NaN)."""
    for a, b in zip(out, ref):
        finite = b[~torch.isnan(b)]
        scale = float(finite.abs().max()) if finite.numel() else 1.0
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * max(scale, 1.0),
                                   equal_nan=True)


# chip_smoke.py's F32_OWN: on the tall template, an f32 output past the
# tolerance is held to this many times the f32 plain version's own distance
# from the plain version in f64 on the same inputs (its sums run in another
# order; at (62, 2) the f32 plain version is about 1e-4 from f64)
F32_OWN = 4.0


def _assert_close_or_own(out, ref, ref64, tol):
    """``_assert_close_scaled``; where ``ref64`` (the plain version in f64
    on the same f32 inputs) is given, an output past the tolerance passes
    within F32_OWN times the f32 plain version's own distance from it."""
    for a, b, c in zip(out, ref, ref64 or ref):
        try:
            _assert_close_scaled((a,), (b,), tol)
        except AssertionError:
            if ref64 is None:
                raise
            keep = ~torch.isnan(c)
            assert torch.equal(torch.isnan(a), torch.isnan(c))
            e = float((a.double() - c)[keep].abs().max())
            e32 = float((b.double() - c)[keep].abs().max())
            assert e <= F32_OWN * e32, (e, e32)


def _ring_edges(depth, Tm1=100, tall=False):
    """(B, Tm1) cases around a recursion template's ring of ``depth`` step
    tiles: the main path's shape, a ragged lane edge on the 16-byte copies
    (1000), one whose runs are not 16-byte aligned (4097: the one-value
    copies), a single partial block (31), and horizons shorter than, just
    under and just over the ring (Tm1 = 0 runs no step).  On the tall
    template (n + m > 32, 8 to 1 lanes a block) numpy's stacks of 4096
    lanes take gigabytes and minutes: 64 lanes (16 blocks or more), 65
    (ragged, runs not 16-byte aligned) and 7 (one partial block at 8 lanes)
    instead, the ring's edges at 8 lanes."""
    if tall:
        return ((64, Tm1), (65, Tm1), (7, Tm1),
                (8, 0), (8, 1), (8, depth - 1), (8, depth + 1))
    return ((4096, Tm1), (1000, Tm1), (4097, Tm1), (31, Tm1),
            (64, 0), (64, 1), (64, depth - 1), (64, depth + 1))


def _poison(n, m):
    """The guu entry that makes Quu indefinite: past n + m = 32, fu^T P fu
    reaches thousands, past -1e3."""
    return -1.0e3 if n + m <= 32 else -1.0e6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("n,m", [(4, 1), (2, 1)])
def test_riccati_kernel_matches_plain(n, m, dtype, tol):
    """K1 at the main path's shapes (acrobot n=4, m=1, T=101, B=4096; and
    particle's and pendulum's n=2, m=1) and at the edges of its ring of step
    tiles (``_ring_edges``), with indefinite Quu on every 61st lane.
    Tolerance relative to the largest value: the two sum in other orders
    (and the kernel contracts to FMA) through a 100-step recursion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    depth, _ = pk.riccati_ring(n, m, dtype, masked=False)
    for B, Tm1 in _ring_edges(depth):
        st = _stacks(np.random.default_rng(5), B, Tm1, n, m)
        bad = np.zeros(B, bool)
        if Tm1 > 0:
            bad[::61] = True
            st[5][Tm1 // 2, 0, 0, bad] = -1.0e3
        dev = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in st]
        kin = [a.contiguous() for a in pk.prepare_stacks(
            *dev, torch.ones((Tm1, m), dtype=torch.bool))]
        reg = torch.zeros(B, dtype=dtype, device="cuda")
        before = pk.RICCATI_LAUNCHES.launches
        out = pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
        torch.cuda.synchronize()
        assert pk.RICCATI_LAUNCHES.launches == before + 1
        ref = pk.backward_pass_multiref_reference(kin[:7], kin[7], kin[8], reg)
        _assert_close_scaled(out, ref, tol)
        assert torch.equal(out[-1].cpu() == 0, torch.as_tensor(bad)), (B, Tm1)


def _wide_stacks(rng, B, Tm1, n, m):
    """Well-conditioned batch-last stacks with m > 1: symmetric positive
    definite gxx and guu (numpy, f64)."""
    T = Tm1 + 1

    def spd(rows, d, scale):
        A = rng.standard_normal((rows, d, d, B))
        return (scale * np.einsum("tikb,tjkb->tijb", A, A) / d
                + 2.0 * np.eye(d)[None, :, :, None])

    fx = 0.1 * rng.standard_normal((Tm1, n, n, B)) + np.eye(n)[None, :, :, None]
    fu = 0.5 * rng.standard_normal((Tm1, n, m, B))
    gx = rng.standard_normal((T, n, B))
    gu = rng.standard_normal((Tm1, m, B))
    return [fx, fu, gx, gu, spd(T, n, 0.5), spd(Tm1, m, 1.0),
            0.2 * rng.standard_normal((Tm1, m, n, B))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_riccati_wide_kernel_matches_plain(dtype, tol):
    """K2 at the quadrotor's shapes (n=12, m=4, T=41, B=4096) and at the
    edges of its ring of step tiles (``_ring_edges``: B=1000, 4097, 31;
    Tm1 = 0, 1, D-1, D+1), with indefinite Quu on every 61st lane; the
    wrapper launches K2 and not K1.  Tolerances as K1's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, m = 12, 4
    depth, _ = pk.riccati_ring(n, m, dtype, masked=False)
    for B, Tm1 in _ring_edges(depth, Tm1=40):
        st = _wide_stacks(np.random.default_rng(6), B, Tm1, n, m)
        bad = np.zeros(B, bool)
        if Tm1 > 0:
            bad[::61] = True
            st[5][Tm1 // 2, 0, 0, bad] = -1.0e3
        dev = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in st]
        kin = [a.contiguous() for a in pk.prepare_stacks(
            *dev, torch.ones((Tm1, m), dtype=torch.bool))]
        reg = torch.full((B,), 0.1, dtype=dtype, device="cuda")
        before = (pk.RICCATI_LAUNCHES.launches, pk.RICCATI_WIDE_LAUNCHES.launches)
        out = pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
        torch.cuda.synchronize()
        assert (pk.RICCATI_LAUNCHES.launches, pk.RICCATI_WIDE_LAUNCHES.launches) == (
            before[0], before[1] + 1)
        ref = pk.backward_pass_multiref_reference(kin[:7], kin[7], kin[8], reg)
        _assert_close_scaled(out, ref, tol)
        assert torch.equal(out[-1].cpu() == 0, torch.as_tensor(bad)), (B, Tm1)


@pytest.mark.cuda
def test_riccati_kernel_rejects_what_it_was_not_built_for():
    """Dims past the rule's range (one lane and one step tile do not fit a
    block: (120, 1) in f32) raise on a CUDA tensor, naming the rule, in
    K1/K2's wrapper and in K5's, K6a's and K6b's entries (no plain version
    runs in their place); so does a non-contiguous stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, Tm1, n, m = 64, 5, 120, 1
    st = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
          for a in _wide_stacks(np.random.default_rng(1), B, Tm1, n, m)]
    kin = [a.contiguous() for a in pk.prepare_stacks(
        *st, torch.ones((Tm1, m), dtype=torch.bool))]
    reg = torch.zeros(B, device="cuda")
    with pytest.raises(NotImplementedError, match="riccati_plan.*the fit rule"):
        pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
    from iterativelqr_tpu_torch.ops import pallas_backward as pb

    lead = [a.movedim(-1, 0).contiguous() for a in st]
    for entry in (pk.backward_pass_batched_pallas_v3, pb.backward_pass_batched_pallas,
                  pb.backward_pass_batched_pallas_v2):
        with pytest.raises(NotImplementedError, match="n=120, m=1"):
            entry(*lead, torch.ones((Tm1, m), dtype=torch.bool), reg)
    st4 = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
           for a in _stacks(np.random.default_rng(1), B, Tm1, 4, 1)]
    kin4 = pk.prepare_stacks(*st4, torch.ones((Tm1, 1), dtype=torch.bool))
    with pytest.raises(ValueError, match="contiguous"):
        pk.backward_pass_multiref(
            (kin4[0].transpose(0, 1).contiguous().transpose(0, 1),) + tuple(kin4[1:7]),
            kin4[7].contiguous(), kin4[8].contiguous(), reg)


RICCATI_GRID = ((3, 1), (4, 2), (5, 1), (5, 2), (6, 2), (7, 3), (13, 4), (14, 7), (24, 8),
                # past n + m = 32: the tall template (past n + m = 64 at
                # (70, 4) and (4, 70))
                (20, 13), (24, 12), (36, 12), (48, 16), (62, 2), (2, 62), (70, 4), (4, 70))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("n,m", RICCATI_GRID)
def test_riccati_family_at_any_dims_matches_plain(n, m, dtype, tol):
    """At dims no registered model has (chip_smoke.py phase 10's and 11's
    grids, on K1's template, on K2's at 32, 16 or 8 lanes a block, or past
    n + m = 32 on the tall template at 8 to 1 lanes): the library built at
    first use reports the plan's ring; K1 or K2 at the edges of that ring
    (``_ring_edges``, T=41), with indefinite Quu on every 61st lane and a
    per-lane regularizer, launched once each on its template's counter;
    then K5, K6a and K6b (``_check_packed_masked``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    plan = pk.riccati_plan(n, m, dtype)
    for masked in (False, True):
        assert pk.riccati_ring(n, m, dtype, masked) == (plan.depth[masked], plan.shared[masked])
    counter = pk.family_counter(pk.RICCATI_LAUNCHES, pk.RICCATI_WIDE_LAUNCHES, plan,
                                pk.RICCATI_TALL_LAUNCHES)
    make = _stacks if m == 1 else _wide_stacks
    for B, Tm1 in _ring_edges(plan.depth[0], Tm1=40, tall=plan.tall):
        rng = np.random.default_rng(9)
        st = make(rng, B, Tm1, n, m)
        bad = np.zeros(B, bool)
        if Tm1 > 0:
            bad[::61] = True
            st[5][Tm1 // 2, 0, 0, bad] = _poison(n, m)
        dev = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in st]
        kin = [a.contiguous() for a in pk.prepare_stacks(
            *dev, torch.ones((Tm1, m), dtype=torch.bool))]
        reg = torch.as_tensor(rng.uniform(1e-3, 1.0, B), dtype=dtype, device="cuda")
        before = counter.launches
        out = pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        ref = pk.backward_pass_multiref_reference(kin[:7], kin[7], kin[8], reg)
        ref64 = None
        if plan.tall and dtype == torch.float32:
            ref64 = pk.backward_pass_multiref_reference(
                [a.double() for a in kin[:7]], kin[7].double(), kin[8].double(), reg.double())
        _assert_close_or_own(out, ref, ref64, tol)
        assert torch.equal(out[-1].cpu() == 0, torch.as_tensor(bad)), (B, Tm1)
    for kernel in ("K5", "K6a", "K6b"):
        _check_packed_masked(kernel, n, m, dtype, tol, 40)


def _rollout_case(name, T, B, dtype, seed, spec=None):
    """Live line-search arrays on the card, from a numpy seed (for the
    registered model ``name``, or ``spec``, the same problem written
    otherwise): states
    rolled out from noisy controls, random non-converged gains, duals with
    lam = 0 on half the lanes (there an inequality row with c < 0 is
    inactive) and, for car and the quadrotor, lanes that head through the
    obstacle or push a control past its bound (active rows); for cartpole,
    lanes past its control limit at the last steps."""
    mod = {"acrobot": acrobot, "acrobot_nc0": acrobot, "car": car, "quadrotor": quadrotor,
           "particle": particle, "pendulum": pendulum, "cartpole": cartpole}[name]
    dyn, cost, con = mod.problem(T)[:3]
    if name == "acrobot_nc0":
        con = [Constraint() for _ in range(T)]   # the goal dropped: no constraint rows
    spec = build_spec(dyn, cost, con) if spec is None else spec
    r = fk.Rollouts(spec, "cuda")
    rng = np.random.default_rng(seed)
    nx, nu, nc, Tm1 = spec.nx, spec.nu, spec.nc, T - 1
    x0 = 0.05 * rng.standard_normal((nx, B))
    ubar = 0.1 * rng.standard_normal((Tm1, nu, B))
    if name == "car":
        ubar[:, 0] += 0.7
        x0[2, ::3] += np.pi / 4
        ubar[:, 0, 1::5] = 6.0
    if name == "quadrotor":
        # thrusts near hover, every rotor past a bound on some lanes
        ubar = quadrotor.HOVER + 0.1 * ubar
        ubar[:, :, 1::5] = 6.5
        ubar[:, :, 3::7] = -0.2
    if name == "cartpole":
        # near theta = pi: a pole released near theta = 0 falls along the
        # separatrix, where a 100-step rollout magnifies rounding about
        # 1e5-fold (the plain f32 rollout is 5e-3 off the f64 one there,
        # 2e-6 here); the last two controls past the limit on some lanes
        x0[1] += np.pi
        ubar[-2:, 0, 1::5] = 10.5
        ubar[-2:, 0, 2::7] = -10.5
    K = 0.1 * rng.standard_normal((Tm1, nu, nx, B))
    k = 0.1 * rng.standard_normal((Tm1, nu, B))
    if name == "quadrotor":
        K, k = 0.2 * K, 0.2 * k   # larger random gains tip the attitude over
    duals = np.abs(0.5 * rng.standard_normal((T, nc, B))) * (rng.uniform(size=B) < 0.5)
    penalty = 10.0 * rng.uniform(0.5, 2.0, (T, nc, B))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
    ws = torch.zeros((T, 0, B), dtype=dtype, device="cuda")
    xbar0 = torch.zeros((T, nx, B), dtype=dtype, device="cuda")
    xbar0[0] = t(x0)
    # zero gains: the plain re-roll is the open-loop rollout of ubar
    xbar = fk.winner_reroll_reference(
        r, torch.zeros(B, dtype=dtype, device="cuda"), xbar0, t(ubar), ws,
        t(0 * K), t(0 * k), t(duals), t(penalty))[0].contiguous()
    return r, (xbar, t(ubar), ws, t(K), t(k), t(duals), t(penalty))


def _close(a, b, tol):
    finite = torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), finite)
    scale = float(b[finite].abs().max()) if finite.any() else 1.0
    torch.testing.assert_close(a[finite], b[finite], rtol=tol,
                               atol=tol * max(scale, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name,T", [("acrobot", 101), ("acrobot_nc0", 101), ("car", 51),
                                    ("quadrotor", 41), ("particle", 11), ("pendulum", 51),
                                    ("cartpole", 101)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_rollout_kernels_match_plain(name, T, dtype, tol):
    """K3 (head, tail, and 20 candidates over two block rows) and K4 against
    their plain versions on the same card inputs, for every registered
    device model: B=1000 and 31 (ragged lane edges), B=4097 (runs not
    16-byte aligned: the ring's one-value copies), and horizons around the
    kernels' ring of D step tiles (T = 2, D, D+1, D+2; D = 2 for a model
    without a ring); and K4's J equal to K3's at the same alpha.  Tolerance relative
    to the largest value, as K1's: the two sum in other orders and the
    kernels contract to FMA, through T-1 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the kernels' ring (0 tiles where they load their step inputs in the
    # step)
    depth = max(fk.rollout_ring(_rollout_case(name, 2, 32, dtype, seed=3)[0].model, dtype)[0], 2)
    for B, TT in ((1000, T), (4097, T), (31, T), (4097, 2), (4097, depth), (4097, depth + 1),
                  (4097, depth + 2)):
        r, live = _rollout_case(name, TT, B, dtype, seed=3)
        before = (fk.SCORE_LAUNCHES.launches, fk.REROLL_LAUNCHES.launches)
        for j0, nb in ((0, 8), (8, 9), (0, 20)):
            J = fk.score_rollout(r, j0, nb, *live)
            torch.cuda.synchronize()
            _close(J, fk.score_rollout_reference(r, j0, nb, *live), tol)
        rng = np.random.default_rng(4)
        j = torch.as_tensor(rng.integers(0, 17, B), device="cuda")
        alpha = (0.5 ** j).to(dtype)
        outs = fk.winner_reroll(r, alpha, *live)
        torch.cuda.synchronize()
        for a, b in zip(outs, fk.winner_reroll_reference(r, alpha, *live)):
            _close(a, b, tol)
        # K4's J at alpha = 2^-j is K3's J of candidate j, exactly: the
        # Armijo choice compares K3's values and keeps K4's re-roll
        J3 = fk.score_rollout(r, 0, 17, *live)[j, torch.arange(B, device="cuda")]
        same = (outs[2] == J3) | (torch.isnan(outs[2]) & torch.isnan(J3))
        assert bool(same.all()), (B, TT, int((~same).sum()))
        assert (fk.SCORE_LAUNCHES.launches, fk.REROLL_LAUNCHES.launches) == (
            before[0] + 4, before[1] + 1)


@pytest.mark.cuda
def test_rollout_kernels_refuse_what_they_cannot_run():
    """A spec with no device model (a stage function with an op that does
    not lower to a device function), a dtype without a kernel, and a
    non-contiguous input raise before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    T, B = 9, 64
    r, live = _rollout_case("car", T, B, torch.float32, seed=1)
    dyn, cost, con, *_ = acrobot.problem(T)
    mine = Cost(lambda x, u: 0.3 * torch.sort(torch.cat([u, x[:1]])).values[0] ** 2, 4, 1)
    r_foreign = fk.Rollouts(build_spec(dyn, [mine] * (T - 1) + cost[-1:], con), "cuda")
    _, a_live = _rollout_case("acrobot", T, B, torch.float32, seed=1)
    with pytest.raises(ValueError, match="no device model"):
        fk.score_rollout(r_foreign, 0, 8, *a_live)
    with pytest.raises(ValueError, match="float32 or float64"):
        fk.score_rollout(r, 0, 8, *(a.half() for a in live))
    K_nc = live[3].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fk.winner_reroll(r, torch.ones(B, device="cuda"), *live[:3], K_nc, *live[4:])


_USER = {"acrobot": acrobot_lambdas, "farm": farm_problem, "demo": demo_problem,
         "team": lambda T, device: quadrotor_team(P, torch, T)}


def _user_case(name, T, B, dtype, seed):
    """Live line-search arrays for a generated device model, from a numpy
    seed: the acrobot's functions in lambdas, examples/mpc_farm.py's
    problem, or examples/sensitivity_demo.py's with a different target ramp
    in w on every lane, or the team of three quadrotors (about their
    starts, hover thrust, gentler gains); random non-converged gains, duals
    with lam = 0 on half the lanes."""
    spec = acrobot_lambdas(T) if name == "acrobot" else _USER[name](T, "cuda")
    r = fk.Rollouts(spec, "cuda")
    rng = np.random.default_rng(seed)
    nx, nu, nc, npar, Tm1 = spec.nx, spec.nu, spec.nc, spec.npar, T - 1
    x0 = (0.05 if name in ("acrobot", "team") else 0.3) * rng.standard_normal((nx, B))
    ubar = 0.1 * rng.standard_normal((Tm1, nu, B))
    K = 0.1 * rng.standard_normal((Tm1, nu, nx, B))
    k = 0.1 * rng.standard_normal((Tm1, nu, B))
    duals = np.abs(0.5 * rng.standard_normal((T, nc, B))) * (rng.uniform(size=B) < 0.5)
    penalty = 10.0 * rng.uniform(0.5, 2.0, (T, nc, B))
    if name == "team":
        # thrusts near hover and gentler gains, as the registered
        # quadrotor's case: 0.1 N(0, 1) thrusts tip some lanes' attitudes
        # over within the horizon, where the rollout magnifies rounding
        # (J near 1e13, kernel and plain 2e-3 apart in f64)
        for i, p in enumerate(team_starts()):
            x0[12 * i:12 * i + 3] += np.asarray(p)[:, None]
        ubar = quadrotor.HOVER + 0.1 * ubar
        K, k = 0.2 * K, 0.2 * k
    ws = np.zeros((T, npar, B))
    if npar:
        ramp = np.linspace(0.0, 1.0, T)[:, None]
        ws[:, 0] = ramp * rng.uniform(0.5, 1.5, B)
        ws[:, 1] = rng.uniform(-0.2, 0.2, B)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
    xbar0 = torch.zeros((T, nx, B), dtype=dtype, device="cuda")
    xbar0[0] = t(x0)
    xbar = fk.winner_reroll_reference(
        r, torch.zeros(B, dtype=dtype, device="cuda"), xbar0, t(ubar), t(ws),
        t(0 * K), t(0 * k), t(duals), t(penalty))[0].contiguous()
    return r, (xbar, t(ubar), t(ws), t(K), t(k), t(duals), t(penalty))


# the ring of step tiles each generated model's K3/K4 report (tiles, bytes
# a block): csrc/sl_rollout.cuh's rule, mirrored in
# tests/test_torch_quadrotor_team.py::_ring_rule; farm and demo load their
# step inputs in the step, the team's two f64 tiles pass a block
GENERATED_RINGS = {("acrobot", torch.float64): (8, 20608), ("acrobot", torch.float32): (8, 10368),
                   ("farm", torch.float64): (0, 0), ("farm", torch.float32): (0, 0),
                   ("demo", torch.float64): (0, 0), ("demo", torch.float32): (0, 0),
                   ("team", torch.float64): (1, 139792), ("team", torch.float32): (2, 139808)}


@pytest.mark.cuda
@pytest.mark.parametrize("name,T", [("acrobot", 101), ("farm", 11), ("demo", 11),
                                    ("team", 41)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_generated_rollout_kernels_match_plain(name, T, dtype, tol):
    """K3 (head and tail) and K4 of a generated device model against their
    plain versions on the same card inputs, at B=4096, 1000, 4097 and 31
    (aligned, ragged, one-value copies, one partial block), and K4's J
    equal to K3's at the same alpha; the launches count on the generated
    symbols.  Tolerances as the registered models'.  The team's (36, 12)
    model reports the ring its dims give (1 tile in f64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for B in (4096, 1000, 4097, 31):
        r, live = _user_case(name, T, B, dtype, seed=3)
        assert r.model.generated is not None, r.model_reason
        assert fk.rollout_ring(r.model, dtype) == GENERATED_RINGS[name, dtype]
        before = (fk.GENERATED_SCORE_LAUNCHES.launches, fk.GENERATED_REROLL_LAUNCHES.launches)
        for j0, nb in ((0, 8), (8, 9)):
            J = fk.score_rollout(r, j0, nb, *live)
            torch.cuda.synchronize()
            _close(J, fk.score_rollout_reference(r, j0, nb, *live), tol)
        j = torch.as_tensor(np.random.default_rng(4).integers(0, 17, B), device="cuda")
        alpha = (0.5 ** j).to(dtype)
        outs = fk.winner_reroll(r, alpha, *live)
        torch.cuda.synchronize()
        for a, b in zip(outs, fk.winner_reroll_reference(r, alpha, *live)):
            _close(a, b, tol)
        J3 = fk.score_rollout(r, 0, 17, *live)[j, torch.arange(B, device="cuda")]
        same = (outs[2] == J3) | (torch.isnan(outs[2]) & torch.isnan(J3))
        assert bool(same.all()), (B, int((~same).sum()))
        assert (fk.GENERATED_SCORE_LAUNCHES.launches,
                fk.GENERATED_REROLL_LAUNCHES.launches) == (before[0] + 3, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_generated_acrobot_matches_the_hand_written_kernel(dtype, tol):
    """The acrobot's functions in lambdas (a generated model) and the
    registered acrobot (csrc/sl_model_acrobot.cuh) score the same
    candidates alike on the same card inputs, T=101, B=4096: the same
    operations, compiled from two sources."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    T, B = 101, 4096
    r_gen, live = _user_case("acrobot", T, B, dtype, seed=5)
    r_hand = fk.Rollouts(build_spec(*acrobot.problem(T)[:3]), "cuda")
    assert r_hand.model.generated is None and r_gen.model.generated is not None
    _close(fk.score_rollout(r_gen, 0, 17, *live), fk.score_rollout(r_hand, 0, 17, *live), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name,T", [("quadrotor", 41), ("car", 51)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_matrix_user_problems_match_plain_and_the_registered_models(name, T, dtype, tol):
    """tests/torch_user_problems.py's quadrotor_matrix and car_user
    (matrices, constant indices, vector_norm; generated device models):
    K3 (head and tail) and K4 against their plain versions, and K3's J
    against the registered hand-written model's on the same inputs (the
    same math in another order of operations), at the lane counts and
    tolerances of test_rollout_kernels_match_plain.  (At B=4096 these
    inputs hold a tumbling quadrotor lane, |J| = 1.1e8, on which the
    hand-written kernel and its plain version differ by 7.7e-8 of J, the
    generated ones by 3.9e-8: over the 1e-10 of the batch's largest J for
    both.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    user = {"quadrotor": quadrotor_matrix, "car": car_user}[name](T, "cuda")
    r_hand = fk.Rollouts(build_spec(*{"quadrotor": quadrotor, "car": car}[name].problem(T)[:3]),
                         "cuda")
    assert r_hand.model.generated is None
    for B in (1000, 4097, 31):
        r, live = _rollout_case(name, T, B, dtype, seed=3, spec=user)
        assert r.model.generated is not None, r.model_reason
        for j0, nb in ((0, 8), (8, 9)):
            J = fk.score_rollout(r, j0, nb, *live)
            torch.cuda.synchronize()
            _close(J, fk.score_rollout_reference(r, j0, nb, *live), tol)
            _close(J, fk.score_rollout(r_hand, j0, nb, *live), tol)
        alpha = (0.5 ** torch.as_tensor(np.random.default_rng(4).integers(0, 17, B),
                                        device="cuda")).to(dtype)
        for a, b in zip(fk.winner_reroll(r, alpha, *live),
                        fk.winner_reroll_reference(r, alpha, *live)):
            _close(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["actionless", "lift_project"])
def test_padded_problems_run_k1_on_the_sl_route(name):
    """tests/test_torch_padding.py's padded problems (actionless steps at
    (2, 1), R2 -> R3 -> R2 at (3, 2)) on the SL route with
    backward_pass="packed", f64, B=64: K1 runs their backward passes, and
    the card's solve equals the CPU path's (equal iterations, trajectories
    within 1e-10), with the padding exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B = 64
    make = {"actionless": padded_actionless, "lift_project": padded_lift_project}[name]
    x0 = 0.3 * np.random.default_rng(3).standard_normal((B, 2))
    extra = {"max_dual_updates": 12} if name == "lift_project" else {}
    opts = Options(verbose=False, record_traces=False, batched_solver="sl",
                   backward_pass="packed", **extra)
    sols = {}
    for dev in ("cuda", "cpu"):
        spec = make(P, torch, device=dev)
        xs = torch.zeros((B, spec.T, spec.nx), dtype=torch.float64, device=dev)
        xs[:, 0, :2] = torch.as_tensor(x0, device=dev)
        us = torch.zeros((B, spec.T - 1, spec.nu), dtype=torch.float64, device=dev)
        ws = torch.zeros((B, spec.T, 0), dtype=torch.float64, device=dev)
        before = pk.RICCATI_LAUNCHES.launches
        sols[dev] = P.make_batched_solve_fn(spec, opts, device=dev, dtype=torch.float64)(
            xs, us, ws)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert pk.RICCATI_LAUNCHES.launches > before
    card, cpu = sols["cuda"], sols["cpu"]
    assert torch.equal(card.iterations.cpu(), cpu.iterations)
    _assert_close_scaled([card.xs.cpu(), card.us.cpu()], [cpu.xs, cpu.us], 1e-10)
    assert float(card.max_violation.max()) <= 5e-3
    if name == "actionless":
        assert bool((card.us[:, 1::2] == 0).all()) and bool((card.K[:, 1::2] == 0).all())
    else:
        assert bool((card.xs[:, 0, 2] == 0).all()) and bool((card.xs[:, 3, 2] == 0).all())


@pytest.mark.cuda
def test_refused_specs_keep_the_loops_on_the_card():
    """A data-dependent branch and an op outside the whitelist (a matrix
    decomposition): "pallas" raises naming it; "auto" takes the loops, and
    no K3/K4 launches."""
    from iterativelqr_tpu_torch.ops.sl_ops import SLOps

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    T = 9
    dyn, cost, con, *_ = acrobot.problem(T)
    branch = Cost(lambda x, u: x[2] * x[2] if x[2] > 0 else u[0] * u[0], 4, 1)
    inv = Cost(lambda x, u: torch.linalg.inv((1.0 + u * u).reshape(1, 1))[0, 0], 4, 1)
    for g, what in ((branch, "data-dependent"), (inv, "aten.linalg_inv_ex")):
        spec = build_spec(dyn, [g] * (T - 1) + cost[-1:], con)
        with pytest.raises(ValueError, match=what):
            SLOps(spec, Options(forward_kernel="pallas"), "cuda")
        assert not SLOps(spec, Options(forward_kernel="auto"), "cuda").use_kernels


def _check_packed_masked(kernel, n, m, dtype, tol, Tm1):
    """K5, K6a or K6b at (n, m) against its plain version at the edges of
    its template's ring (``_ring_edges``), with indefinite Quu on every 61st
    lane, the last action masked (m > 1, nonzero derivative entries) and a
    per-lane regularizer from [1e-3, 1]."""
    from iterativelqr_tpu_torch.ops import pallas_backward as pb

    depth, _ = pk.riccati_ring(n, m, dtype, masked=kernel != "K5")
    make = _stacks if m == 1 else _wide_stacks
    plan = pk.riccati_plan(n, m, dtype)
    for B, Tm1_ in _ring_edges(depth, Tm1=Tm1, tall=plan.tall):
        rng = np.random.default_rng(8)
        st = make(rng, B, Tm1_, n, m)
        bad = np.zeros(B, bool)
        if Tm1_ > 0:
            bad[::61] = True
            st[5][Tm1_ // 2, 0, 0, bad] = _poison(n, m)
        st = [torch.as_tensor(a, dtype=dtype, device="cuda").contiguous() for a in st]
        um = torch.ones((Tm1_, m), dtype=dtype, device="cuda")
        if m > 1:
            um[:, -1] = 0.0
        reg = torch.as_tensor(rng.uniform(1e-3, 1.0, B), dtype=dtype, device="cuda")
        # the plain versions in f64 on the same (f32) inputs
        st64, um64, reg64 = [a.double() for a in st], um.double(), reg.double()
        if kernel == "K5":
            packed, gxxT, gxT, meta = pk.pack_stacks_bt(*st, um > 0.5)
            counter = pk.family_counter(pk.RICCATI_PACKED_LAUNCHES,
                                        pk.RICCATI_PACKED_WIDE_LAUNCHES, plan,
                                        pk.RICCATI_PACKED_TALL_LAUNCHES)
            run = lambda: pk.backward_pass_packed(packed, gxxT, gxT, reg, meta)
            plain = lambda: pk.backward_pass_packed_reference(packed, gxxT, gxT, reg, meta)
            plain64 = lambda: pk.backward_pass_packed_reference(
                packed.double(), gxxT.double(), gxT.double(), reg64, meta)
        elif kernel == "K6a":
            counter = pk.family_counter(pb.RICCATI_MASKED_LAUNCHES,
                                        pb.RICCATI_MASKED_WIDE_LAUNCHES, plan,
                                        pb.RICCATI_MASKED_TALL_LAUNCHES)
            run = lambda: pb.backward_pass_masked(*st, um, reg)
            plain = lambda: pb.backward_pass_masked_reference(*st, um, reg)
            plain64 = lambda: pb.backward_pass_masked_reference(*st64, um64, reg64)
        else:
            packed = pk.pack_slots((st[0], st[1], st[2][:-1], st[3], st[4][:-1], st[5], st[6]))
            gxxT, gxT, meta = st[4][-1].contiguous(), st[2][-1].contiguous(), dict(n=n, m=m)
            counter = pk.family_counter(pb.RICCATI_MASKED_PACKED_LAUNCHES,
                                        pb.RICCATI_MASKED_PACKED_WIDE_LAUNCHES, plan,
                                        pb.RICCATI_MASKED_PACKED_TALL_LAUNCHES)
            run = lambda: pb.backward_pass_masked_packed(packed, gxxT, gxT, um, reg, meta)
            plain = lambda: pb.backward_pass_masked_packed_reference(packed, gxxT, gxT, um, reg,
                                                                     meta)
            plain64 = lambda: pb.backward_pass_masked_packed_reference(
                packed.double(), gxxT.double(), gxT.double(), um64, reg64, meta)
        before = counter.launches
        out = run()
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        _assert_close_or_own(out, plain(), plain64() if plan.tall and dtype == torch.float32
                             else None, tol)
        assert torch.equal(out[-1].cpu() == 0, torch.as_tensor(bad)), (B, Tm1_)
        if m > 1 and kernel != "K5":
            good = torch.as_tensor(~bad, device="cuda")
            assert bool((out[0][:, -1][..., good] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("kernel,n,m", [("K5", 4, 1), ("K6a", 4, 1), ("K6a", 3, 2),
                                        ("K6b", 4, 1), ("K6b", 3, 2), ("K5", 2, 1),
                                        ("K6a", 2, 1), ("K6b", 2, 1)])
def test_packed_and_masked_kernels_match_plain(kernel, n, m, dtype, tol):
    """K5, K6a and K6b at T=101, B=1000 (a ragged lane edge) and at the
    edges of their ring of step tiles (``_ring_edges``) against their plain
    versions, with indefinite Quu on every 61st lane; at (3, 2) the last
    action is masked with nonzero derivative entries, so the mask is what
    zeroes its gains.  A per-lane regularizer drawn from [1e-3, 1], so K5's
    whole-diagonal reg and K6's reg * um (and K6b's order of adding and
    taking it back) are held against the plain versions.  Tolerances as
    K1's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _check_packed_masked(kernel, n, m, dtype, tol, Tm1=100)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("kernel", ["K5", "K6a", "K6b"])
def test_wide_packed_and_masked_kernels_match_plain(kernel, dtype, tol):
    """K5, K6a and K6b at the quadrotor's (12, 4), instantiations of K2's
    template, against their plain versions at T=41 and the edges of K2's
    ring, as ``test_packed_and_masked_kernels_match_plain`` holds them at
    K1's dims; each launch counts on the wide kernel's counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _check_packed_masked(kernel, 12, 4, dtype, tol, Tm1=40)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_associative_scan_on_the_card_matches_the_cpu(dtype, tol):
    """ops/assoc.py (plain torch operations, no kernel) on the card against
    the same call on the CPU, acrobot's (4, 1) at T=101, B=64 and one
    instance: IEEE arithmetic in other reduction orders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from iterativelqr_tpu_torch.ops import assoc

    st = [np.moveaxis(a, -1, 0).copy() for a in _stacks(np.random.default_rng(9), 64, 100, 4, 1)]
    um = torch.ones((100, 1), dtype=torch.bool)
    for lanes in (slice(None), 0):
        args = [torch.as_tensor(a[lanes], dtype=dtype) for a in st]
        reg = torch.zeros(args[0].shape[:-3], dtype=dtype)
        ref = assoc.backward_pass_associative(*args, um, reg)
        out = assoc.backward_pass_associative(*(a.cuda() for a in args), um.cuda(), reg.cuda())
        assert bool(out[5].all()) and bool(ref[5].all())
        _assert_close_scaled([o.cpu() for o in out[:5]], ref[:5], tol)


def _car_spread(T=8, B=256):
    """Car T=8, B=256, f32 on the card: x0 = x1 + 0.3 N(0,1), controls
    0.01, states rolled out; the options of the compaction tests with the
    rollout kernels."""
    from torch.func import vmap

    dyn, cost, con, x1, _ = car.problem(T)
    spec = build_spec(dyn, cost, con)
    x = torch.as_tensor(x1.numpy() + 0.3 * np.random.default_rng(11).standard_normal((B, 3)),
                        dtype=torch.float32, device="cuda")
    us = torch.full((B, T - 1, 2), 0.01, device="cuda")
    xs = [x]
    for t in range(T - 1):
        x = vmap(dyn[t])(x, us[:, t])
        xs.append(x)
    args = (torch.stack(xs, dim=1), us, torch.zeros((B, T, 0), device="cuda"))
    opts = Options(record_traces=False, backward_pass="packed", max_iterations=10,
                   max_dual_updates=4, forward_kernel="pallas", batched_solver="sl")
    return spec, opts, args


@pytest.mark.cuda
def test_compacted_solve_on_the_card_matches_single_shot():
    """core/solve_compact.py on the card with a grain of 32 lanes (car T=8,
    B=256, f32, the rollout kernels): the batch repacks, and each lane's
    iterations equal the single-shot SL solve's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from iterativelqr_tpu_torch.core import solve_compact
    from iterativelqr_tpu_torch.core.solve_sl import make_batched_solve_sl

    spec, opts, args = _car_spread()
    ref = make_batched_solve_sl(spec, opts, device="cuda")(*args)
    grain = solve_compact.GRAIN
    solve_compact.GRAIN = 32
    try:
        solve = solve_compact.make_compacted_solve_fn(spec, opts, chunk=4, rescue=False)
        out = solve(*args)
    finally:
        solve_compact.GRAIN = grain
    assert solve.last_run.repacks >= 1
    assert torch.equal(out.iterations, ref.iterations)
    torch.testing.assert_close(out.xs, ref.xs, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["sharded", "compacted"])
def test_two_entries_on_one_card_equal_one_solve(route):
    """Two mesh entries on cuda:0 (car T=8, B=256, f32, the kernels): the
    batch-sharded SL solve (parallel/shard.py) against the single-shot SL
    solve, and per-device compaction against the single-device loop;
    every lane's iterations, xs and us bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from iterativelqr_tpu_torch.core import solve_compact
    from iterativelqr_tpu_torch.core.solve_sl import make_batched_solve_sl
    from iterativelqr_tpu_torch.parallel import default_mesh, make_sharded_solve_fn

    spec, opts, args = _car_spread()
    devices = [torch.device("cuda", 0)] * 2
    if route == "sharded":
        ref = make_batched_solve_sl(spec, opts, device="cuda")(*args)
        out, _ = make_sharded_solve_fn(spec, opts, mesh=default_mesh(devices))(*args)
    else:
        grain = solve_compact.GRAIN
        solve_compact.GRAIN = 32
        try:
            ref = solve_compact.make_compacted_solve_fn(spec, opts, chunk=4)(*args)
            out = solve_compact.make_compacted_solve_fn(spec, opts, chunk=4, devices=devices)(*args)
        finally:
            solve_compact.GRAIN = grain
    for f in ("iterations", "xs", "us"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


@pytest.mark.cuda
def test_vmap_route_over_distinct_cards_equals_one_card():
    """The vmap route over two cards against the same two shards on cuda:0
    (car T=8, B=256, f32, traces on): iterations, xs, us and the stats
    bitwise equal."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from iterativelqr_tpu_torch.parallel import default_mesh, make_sharded_solve_fn

    spec, _, args = _car_spread()
    opts = Options(max_iterations=10, max_dual_updates=4, batched_solver="vmap")
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    out, stats = make_sharded_solve_fn(spec, opts, mesh=default_mesh(two))(*args)
    ref, want = make_sharded_solve_fn(spec, opts, mesh=default_mesh(two[:1] * 2))(*args)
    for f in ("iterations", "xs", "us"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    for f in stats._fields:
        assert torch.equal(getattr(stats, f), getattr(want, f)), f
