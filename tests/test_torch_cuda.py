"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: here they skip when torch finds no card.  On a machine with
a card and without JAX (which tests/conftest.py imports), run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

This file imports torch and numpy only.
"""

import numpy as np
import pytest
import torch
from torch_user_problems import acrobot_lambdas, demo_problem, farm_problem

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


def _ring_edges(depth, Tm1=100):
    """(B, Tm1) cases around a recursion template's ring of ``depth`` step
    tiles: the main path's shape, a ragged lane edge on the 16-byte copies
    (1000), one whose runs are not 16-byte aligned (4097: the one-value
    copies), a single partial block (31), and horizons shorter than, just
    under and just over the ring (Tm1 = 0 runs no step)."""
    return ((4096, Tm1), (1000, Tm1), (4097, Tm1), (31, Tm1),
            (64, 0), (64, 1), (64, depth - 1), (64, depth + 1))


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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, Tm1 = 64, 5
    st = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
          for a in _stacks(np.random.default_rng(1), B, Tm1, 3, 1)]
    kin = [a.contiguous() for a in pk.prepare_stacks(
        *st, torch.ones((Tm1, 1), dtype=torch.bool))]
    reg = torch.zeros(B, device="cuda")
    # K1's dims without an instantiation
    with pytest.raises(NotImplementedError):
        pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
    # K2's dims without an instantiation
    st53 = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in _wide_stacks(np.random.default_rng(1), B, Tm1, 5, 3)]
    kin53 = [a.contiguous() for a in pk.prepare_stacks(
        *st53, torch.ones((Tm1, 3), dtype=torch.bool))]
    with pytest.raises(NotImplementedError, match="riccati_backward_wide"):
        pk.backward_pass_multiref(kin53[:7], kin53[7], kin53[8], reg)
    # nor K5, K6a, K6b there
    from iterativelqr_tpu_torch.ops import pallas_backward as pb

    lead = [a.movedim(-1, 0).contiguous() for a in st53]
    for entry in (pk.backward_pass_batched_pallas_v3, pb.backward_pass_batched_pallas,
                  pb.backward_pass_batched_pallas_v2):
        with pytest.raises(NotImplementedError, match="n=5, m=3"):
            entry(*lead, torch.ones((Tm1, 3), dtype=torch.bool), reg)
    st4 = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
           for a in _stacks(np.random.default_rng(1), B, Tm1, 4, 1)]
    kin4 = pk.prepare_stacks(*st4, torch.ones((Tm1, 1), dtype=torch.bool))
    with pytest.raises(ValueError, match="contiguous"):
        pk.backward_pass_multiref(
            (kin4[0].transpose(0, 1).contiguous().transpose(0, 1),) + tuple(kin4[1:7]),
            kin4[7].contiguous(), kin4[8].contiguous(), reg)


def _rollout_case(name, T, B, dtype, seed):
    """Live line-search arrays on the card, from a numpy seed: states
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
    spec = build_spec(dyn, cost, con)
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
    mine = Cost(lambda x, u: 0.3 * torch.sinh(u[0]) ** 2, 4, 1)
    r_foreign = fk.Rollouts(build_spec(dyn, [mine] * (T - 1) + cost[-1:], con), "cuda")
    _, a_live = _rollout_case("acrobot", T, B, torch.float32, seed=1)
    with pytest.raises(ValueError, match="no device model"):
        fk.score_rollout(r_foreign, 0, 8, *a_live)
    with pytest.raises(ValueError, match="float32 or float64"):
        fk.score_rollout(r, 0, 8, *(a.half() for a in live))
    K_nc = live[3].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fk.winner_reroll(r, torch.ones(B, device="cuda"), *live[:3], K_nc, *live[4:])


_USER = {"acrobot": acrobot_lambdas, "farm": farm_problem, "demo": demo_problem}


def _user_case(name, T, B, dtype, seed):
    """Live line-search arrays for a generated device model, from a numpy
    seed: the acrobot's functions in lambdas, examples/mpc_farm.py's
    problem, or examples/sensitivity_demo.py's with a different target ramp
    in w on every lane; random non-converged gains, duals with lam = 0 on
    half the lanes."""
    spec = acrobot_lambdas(T) if name == "acrobot" else _USER[name](T, "cuda")
    r = fk.Rollouts(spec, "cuda")
    rng = np.random.default_rng(seed)
    nx, nu, nc, npar, Tm1 = spec.nx, spec.nu, spec.nc, spec.npar, T - 1
    x0 = (0.05 if name == "acrobot" else 0.3) * rng.standard_normal((nx, B))
    ubar = 0.1 * rng.standard_normal((Tm1, nu, B))
    K = 0.1 * rng.standard_normal((Tm1, nu, nx, B))
    k = 0.1 * rng.standard_normal((Tm1, nu, B))
    duals = np.abs(0.5 * rng.standard_normal((T, nc, B))) * (rng.uniform(size=B) < 0.5)
    penalty = 10.0 * rng.uniform(0.5, 2.0, (T, nc, B))
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


@pytest.mark.cuda
@pytest.mark.parametrize("name,T", [("acrobot", 101), ("farm", 11), ("demo", 11)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_generated_rollout_kernels_match_plain(name, T, dtype, tol):
    """K3 (head and tail) and K4 of a generated device model against their
    plain versions on the same card inputs, at B=4096, 1000, 4097 and 31
    (aligned, ragged, one-value copies, one partial block), and K4's J
    equal to K3's at the same alpha; the launches count on the generated
    symbols.  Tolerances as the registered models'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for B in (4096, 1000, 4097, 31):
        r, live = _user_case(name, T, B, dtype, seed=3)
        assert r.model.generated is not None, r.model_reason
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
def test_refused_specs_keep_the_loops_on_the_card():
    """A data-dependent branch and an op outside the whitelist: "pallas"
    raises naming it; "auto" takes the loops, and no K3/K4 launches."""
    from iterativelqr_tpu_torch.ops.sl_ops import SLOps

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    T = 9
    dyn, cost, con, *_ = acrobot.problem(T)
    branch = Cost(lambda x, u: x[2] * x[2] if x[2] > 0 else u[0] * u[0], 4, 1)
    sinh = Cost(lambda x, u: torch.sinh(u[0]) ** 2, 4, 1)
    for g, what in ((branch, "data-dependent"), (sinh, "aten.sinh")):
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
    wide = pk.uses_wide_kernel(n, m)
    for B, Tm1_ in _ring_edges(depth, Tm1=Tm1):
        rng = np.random.default_rng(8)
        st = make(rng, B, Tm1_, n, m)
        bad = np.zeros(B, bool)
        if Tm1_ > 0:
            bad[::61] = True
            st[5][Tm1_ // 2, 0, 0, bad] = -1.0e3
        st = [torch.as_tensor(a, dtype=dtype, device="cuda").contiguous() for a in st]
        um = torch.ones((Tm1_, m), dtype=dtype, device="cuda")
        if m > 1:
            um[:, -1] = 0.0
        reg = torch.as_tensor(rng.uniform(1e-3, 1.0, B), dtype=dtype, device="cuda")
        if kernel == "K5":
            packed, gxxT, gxT, meta = pk.pack_stacks_bt(*st, um > 0.5)
            counter = pk.RICCATI_PACKED_WIDE_LAUNCHES if wide else pk.RICCATI_PACKED_LAUNCHES
            run = lambda: pk.backward_pass_packed(packed, gxxT, gxT, reg, meta)
            plain = lambda: pk.backward_pass_packed_reference(packed, gxxT, gxT, reg, meta)
        elif kernel == "K6a":
            counter = pb.RICCATI_MASKED_WIDE_LAUNCHES if wide else pb.RICCATI_MASKED_LAUNCHES
            run = lambda: pb.backward_pass_masked(*st, um, reg)
            plain = lambda: pb.backward_pass_masked_reference(*st, um, reg)
        else:
            packed = pk.pack_slots((st[0], st[1], st[2][:-1], st[3], st[4][:-1], st[5], st[6]))
            gxxT, gxT, meta = st[4][-1].contiguous(), st[2][-1].contiguous(), dict(n=n, m=m)
            counter = (pb.RICCATI_MASKED_PACKED_WIDE_LAUNCHES if wide
                       else pb.RICCATI_MASKED_PACKED_LAUNCHES)
            run = lambda: pb.backward_pass_masked_packed(packed, gxxT, gxT, um, reg, meta)
            plain = lambda: pb.backward_pass_masked_packed_reference(packed, gxxT, gxT, um, reg,
                                                                     meta)
        before = counter.launches
        out = run()
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        _assert_close_scaled(out, plain(), tol)
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
