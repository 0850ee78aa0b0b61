"""The per-instance backward pass of the port (iterativelqr_tpu_torch/ops/
backward.py, linalg_small.py, al.py) against the JAX package's functions
under ``jax.vmap``, on the same numpy inputs in f64, the per-instance
solve with the associative scan and with ``live_progress``, and what the
port refuses with ``ddp=True`` as the JAX package does.

Tolerance 1e-10 relative to the largest value: both sides are IEEE f64 and
sum the same products, in other orders where XLA fuses its reductions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.ops import al as jal
from iterativelqr_tpu.ops import backward as jbw
from iterativelqr_tpu.ops import linalg_small as jls
from iterativelqr_tpu_torch import Options, build_spec, make_batched_solve_fn, make_solve_fn
from iterativelqr_tpu_torch.models import acrobot
from iterativelqr_tpu_torch.ops import al, backward, linalg_small

torch.set_num_threads(1)

TOL = 1e-10


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    scale = max(np.abs(b[fin]).max(), 1.0) if fin.any() else 1.0
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=tol * scale)


def stacks(rng, B, Tm1, n, m):
    """Batch-leading derivative stacks: symmetric positive definite gxx and
    guu, random dynamics near the identity."""
    T = Tm1 + 1

    def spd(rows, d, scale):
        A = rng.standard_normal((B, rows, d, d))
        return scale * (A @ np.swapaxes(A, -1, -2)) / d + 2.0 * np.eye(d)

    return [0.2 * rng.standard_normal((B, Tm1, n, n)) + np.eye(n),
            rng.standard_normal((B, Tm1, n, m)),
            rng.standard_normal((B, T, n)),
            rng.standard_normal((B, Tm1, m)),
            spd(T, n, 0.5), spd(Tm1, m, 1.0),
            0.2 * rng.standard_normal((B, Tm1, m, n))]


@pytest.mark.parametrize("m", [1, 2, 3])
def test_linalg_small(m):
    rng = np.random.default_rng(m)
    A = rng.standard_normal((5, m, m))
    S = A @ np.swapaxes(A, -1, -2) + m * np.eye(m)
    Bm = rng.standard_normal((5, m, 3))
    v = rng.standard_normal((5, m))
    t = torch.as_tensor
    close(linalg_small.matmul(t(S), t(Bm)), jls.matmul(jnp.asarray(S), jnp.asarray(Bm)))
    close(linalg_small.matvec(t(S), t(v)), jls.matvec(jnp.asarray(S), jnp.asarray(v)))
    L = linalg_small.cholesky(t(S))
    close(L, jls.cholesky(jnp.asarray(S)))
    close(linalg_small.cho_solve(L, t(Bm)), jls.cho_solve(jnp.asarray(np.asarray(L)), jnp.asarray(Bm)))
    close(linalg_small.solve(t(S + 3 * np.eye(m)), t(Bm)),
          jls.solve(jnp.asarray(S + 3 * np.eye(m)), jnp.asarray(Bm)))
    # an indefinite matrix: NaN pivots on both sides
    bad = -S
    np.testing.assert_array_equal(np.isnan(linalg_small.cholesky(t(bad)).numpy()),
                                  np.isnan(np.asarray(jls.cholesky(jnp.asarray(bad)))))


def test_al_terms_match():
    rng = np.random.default_rng(2)
    B, T, nc, nx, nu = 6, 7, 3, 4, 2
    c = rng.standard_normal((B, T, nc))
    duals = np.abs(rng.standard_normal((B, T, nc))) * (rng.uniform(size=(B, T, nc)) < 0.5)
    pen = rng.uniform(1.0, 10.0, (B, T, nc))
    ineq = np.zeros((T, nc), bool)
    ineq[:, 1:] = True
    cmask = np.ones((T, nc), bool)
    cmask[0, 2] = False
    cx = rng.standard_normal((B, T, nc, nx))
    cu = rng.standard_normal((B, T - 1, nc, nu))
    t = torch.as_tensor
    close(al.active_set(t(c), t(duals), t(ineq)), jax.vmap(jal.active_set, (0, 0, None))(c, duals, ineq))
    close(al.al_terms(t(c), t(duals), t(pen), t(ineq)),
          jax.vmap(jal.al_terms, (0, 0, 0, None))(c, duals, pen, ineq))
    close(al.max_violation(t(c), t(ineq), t(cmask)),
          jax.vmap(jal.max_violation, (0, None, None))(c, ineq, cmask))
    scale = np.where(rng.uniform(size=B) < 0.5, 1000.0, 10.0)
    for a, b in zip(al.dual_update(t(c), t(duals), t(pen), t(ineq), t(scale), 1e4),
                    jax.vmap(jal.dual_update, (0, 0, 0, None, 0, None))(c, duals, pen, ineq, scale, 1e4)):
        close(a, b)
    for a, b in zip(al.al_gradient_terms(t(c), t(cx), t(cu), t(duals), t(pen), t(ineq)),
                    jax.vmap(jal.al_gradient_terms, (0, 0, 0, 0, 0, None))(c, cx, cu, duals, pen, ineq)):
        close(a, b)


@pytest.mark.parametrize("n,m", [(4, 1), (3, 2)])
def test_riccati_step_and_scan_match(n, m):
    """One step and the whole reverse scan, with a masked action dim at
    (3, 2) and per-lane regularization."""
    rng = np.random.default_rng(n)
    B, Tm1 = 5, 8
    st = stacks(rng, B, Tm1, n, m)
    um = np.ones((Tm1, m), bool)
    if m > 1:
        um[:, -1] = False
    reg = np.array([0.0, 1e-3, 0.1, 0.0, 2.0])
    t = [torch.as_tensor(a) for a in st]
    out = backward.backward_pass_scan(*t, torch.as_tensor(um), torch.as_tensor(reg))
    ref = jax.vmap(lambda *a: jbw.backward_pass_scan(*a[:7], um, a[7]))(*st, reg)
    for a, b in zip(out, ref):
        close(a, b)
    P = st[4][:, -1]
    p = st[2][:, -1]
    step = backward.riccati_step(
        torch.as_tensor(P), torch.as_tensor(p), *(torch.as_tensor(a[:, 3]) for a in (
            st[0], st[1], st[2], st[3], st[4], st[5], st[6])),
        torch.as_tensor(um[3].astype(np.float64)), torch.as_tensor(reg))
    ref_step = jax.vmap(lambda P, p, *a: jbw.riccati_step(P, p, *a[:7], um[3].astype(np.float64), a[7]))(
        P, p, *(a[:, 3] for a in st), reg)
    for a, b in zip(step, ref_step):
        close(a, b)


def test_backward_pass_retry_matches():
    """The regularization retry per lane: lanes with an indefinite Quu
    escalate reg until their factorizations succeed; the returned
    reg_next (the decayed reg each lane used) fixes each lane's retry count."""
    rng = np.random.default_rng(4)
    B, Tm1, n, m = 6, 8, 4, 1
    st = stacks(rng, B, Tm1, n, m)
    st[5][1, 4] = -50.0       # lane 1: needs reg > about 50
    st[5][3, 2] = -1.0e3      # lane 3: needs reg > about 1e3
    um = np.ones((Tm1, m), bool)
    reg0 = np.array([0.0, 0.0, 1e-2, 0.0, 1e-6, 5.0])
    opts = dict(max_regularization_steps=20)
    t = [torch.as_tensor(a) for a in st]
    out = backward.backward_pass(*t, torch.as_tensor(um), torch.as_tensor(reg0),
                                 Options(backward_pass="scan", **opts))
    ref = jax.vmap(lambda *a: jbw.backward_pass(
        *a[:7], um, a[7], JaxOptions(backward_pass="scan", **opts)))(*st, reg0)
    for a, b in zip(out, ref):
        close(a, b)
    # lanes 1 and 3 escalated; their decayed reg carries on
    assert np.asarray(ref[6])[1] >= 1.0 and np.asarray(ref[6])[3] >= 1e2


@pytest.mark.parametrize("batched", [True, False])
def test_backward_pass_without_attempts_matches(batched):
    """max_regularization_steps < 0: JAX tests the retry loop's condition
    first, so no attempt runs and the pass returns zero gains, ok false and
    the carried reg decayed; the port mirrors that on the batch and on one
    instance (the per-instance form of the solver)."""
    rng = np.random.default_rng(5)
    B = 4 if batched else 1
    st = stacks(rng, B, 6, 3, 2)
    um = np.ones((6, 2), bool)
    reg0 = np.array([0.0, 1e-2, 1.0, 1e-7])[:B]
    opts = dict(max_regularization_steps=-1)
    out = backward.backward_pass(*(torch.as_tensor(a) for a in st), torch.as_tensor(um),
                                 torch.as_tensor(reg0),
                                 Options(backward_pass="scan", **opts), batched=batched)
    ref = jax.vmap(lambda *a: jbw.backward_pass(
        *a[:7], um, a[7], JaxOptions(backward_pass="scan", **opts)))(*st, reg0)
    for a, b in zip(out, ref):
        close(a, b)
    assert not np.asarray(ref[5]).any() and not out[0].any()


def test_auto_dispatch_takes_the_scan_for_batches():
    """backward_pass="auto" under the batched form: the reverse scan at
    B > T // 7 (bitwise the scan); the associative scan for one instance
    and for a small batch (B <= T // 7), each against the JAX package's
    dispatch."""
    rng = np.random.default_rng(5)
    st = stacks(rng, 4, 8, 4, 1)
    t = [torch.as_tensor(a) for a in st]
    um = np.ones((8, 1), bool)
    reg = np.zeros(4)
    out = backward.backward_pass(*t, torch.as_tensor(um), torch.as_tensor(reg),
                                 Options(backward_pass="auto"))
    ref = backward.backward_pass(*t, torch.as_tensor(um), torch.as_tensor(reg),
                                 Options(backward_pass="scan"))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    one = backward.backward_pass(*(a[:1] for a in t), torch.as_tensor(um),
                                 torch.as_tensor(reg[:1]), Options(backward_pass="auto"),
                                 batched=False)
    ref = jbw.backward_pass(*(a[0] for a in st), um, reg[0], JaxOptions(backward_pass="auto"))
    for a, b in zip(one, ref):
        close(a, np.asarray(b)[None])
    long = stacks(rng, 4, 40, 4, 1)
    um = np.ones((40, 1), bool)
    out = backward.backward_pass(*(torch.as_tensor(a) for a in long), torch.as_tensor(um),
                                 torch.as_tensor(reg), Options(backward_pass="auto"))
    ref = jax.vmap(lambda *a: jbw.backward_pass(*a[:7], um, a[7], JaxOptions()))(*long, reg)
    for a, b in zip(out, ref):
        close(a, b)
    assert backward._assoc_wins(4, 41)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(ddp=True), ValueError, "backward_impl cannot be combined with ddp"),
])
def test_unported_options_refuse(kw, exc, match):
    """ddp=True runs (ROADMAP M12, tests/test_torch_ddp.py); what stays
    refused with it is refused as the JAX package refuses it: a
    ``backward_impl`` override, which cannot carry the DDP terms."""
    spec = build_spec(*acrobot.problem(9)[:3])
    with pytest.raises(exc, match=match):
        make_solve_fn(spec, Options(**kw), backward_impl=backward.backward_pass_scan,
                      device="cpu")
    make_solve_fn(spec, Options(**kw), device="cpu")
    make_batched_solve_fn(spec, Options(batched_solver="vmap", **kw), device="cpu")


def one_instance(T=9):
    """Acrobot, one instance: x0 = 0.02 N(0,1), controls 0.05, states
    rolled out open loop (numpy inputs for both packages)."""
    from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
    from iterativelqr_tpu.models import acrobot as jax_acrobot
    from iterativelqr_tpu.ops.rollout import open_loop_rollout

    jspec = jax_build_spec(*jax_acrobot.problem(T)[:3])
    x0 = 0.02 * np.random.default_rng(1).standard_normal(4)
    us = np.full((T - 1, 1), 0.05)
    ws = np.zeros((T, 0))
    xs = np.asarray(open_loop_rollout(jspec, jnp.asarray(x0), jnp.asarray(us), jnp.asarray(ws)))
    return jspec, build_spec(*acrobot.problem(T)[:3]), xs, us, ws


def solve_both(kw, capsys=None):
    """The per-instance solve of both packages on one car instance (T=12,
    tests/test_torch_solve.py's lane 2); the port's and JAX's printed
    output when ``capsys`` is given."""
    from iterativelqr_tpu import make_solve_fn as jax_make_solve_fn
    from test_torch_solve import inputs

    jspec, tspec, *batch = inputs("car")
    xs, us, ws = (a[2] for a in batch)
    ref = jax.jit(jax_make_solve_fn(jspec, JaxOptions(**kw)))(*(jnp.asarray(a) for a in (xs, us, ws)))
    jax.effects_barrier()
    printed = capsys.readouterr().out if capsys else None
    sol = make_solve_fn(tspec, Options(**kw), device="cpu")(*(torch.as_tensor(a) for a in (xs, us, ws)))
    out = capsys.readouterr().out if capsys else None
    for name in ("iterations", "al_iterations", "status"):
        assert int(getattr(sol, name)) == int(getattr(ref, name)), name
    for name in ("xs", "us", "objective", "max_violation"):
        close(getattr(sol, name), getattr(ref, name))
    return sol, out, printed


def test_associative_option_matches_jax():
    """backward_pass="associative" through the per-instance solver."""
    solve_both(dict(backward_pass="associative"))


def test_live_progress_matches_jax(capsys):
    """live_progress=True prints one line per AL round, as the JAX program
    prints through jax.debug.callback: the same lines."""
    sol, out, printed = solve_both(dict(live_progress=True), capsys)
    lines = [ln for ln in out.splitlines() if ln.startswith("  [al")]
    assert "[al  0]" in out and "viol" in out
    assert len(lines) == int(sol.al_iterations)
    jax_lines = [ln for ln in printed.splitlines() if ln.startswith("  [al")]
    assert [ln.split("J")[0] for ln in lines] == [ln.split("J")[0] for ln in jax_lines]


def test_one_instance_with_auto_backward_matches_jax():
    """The per-instance form with backward_pass="auto" takes the
    associative scan."""
    solve_both(dict(backward_pass="auto"))
