"""The port's line-search rollout path (iterativelqr_tpu_torch/ops/
sl_forward_kernel.py, forward_kernel="pallas") against the JAX package's
Pallas rollout kernels in interpret mode, in f64.

On the CPU the port's wrappers run their plain versions, so these tests pin
the path around the kernels: the selector, the eligibility rules, the
device-model registry and the plain loops the CUDA kernels are held
against on the card (tests/test_torch_cuda.py, chip_smoke.py).  Solver
level: equal iterations, AL iterations and status; trajectories, duals and
violations within 1e-10 of the field's largest magnitude, the objective
within 1e-9 of it.  Both packages run the same f64 operations and differ
in the order of a few sums; over 17 iterations of a spinning acrobot
(|xs| up to 24, objective 2.5e4 under AL penalties) that grows to 7e-11
and 4e-10 of those magnitudes.  The line-search unit cases are in
tests/test_torch_sl_forward_unit.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.core.spec import Constraint as JaxConstraint
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import acrobot as jax_acrobot
from iterativelqr_tpu.models import car as jax_car
from iterativelqr_tpu.ops.rollout import open_loop_rollout
from iterativelqr_tpu.parallel.batch import (
    make_batched_solve_fn as jax_make_batched_solve_fn,
)
from iterativelqr_tpu_torch import Constraint, Cost, Options, build_spec
from iterativelqr_tpu_torch import make_batched_solve_fn
from iterativelqr_tpu_torch.convert import (
    batch_from_numpy,
    options_from_fields,
    solution_to_numpy,
)
from iterativelqr_tpu_torch.models import acrobot, car
from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk
from iterativelqr_tpu_torch.ops.sl_ops import SLOps

torch.set_num_threads(1)

TOL = 1e-10
TOL_OBJECTIVE = 1e-9
# tests/test_sl_forward_kernel.py's _BASE
_BASE = dict(record_traces=False, backward_pass="packed", batched_solver="sl",
             max_iterations=12, max_dual_updates=3)
_MODELS = {"acrobot": (jax_acrobot, acrobot), "car": (jax_car, car)}


def specs(name, T, nc0=False):
    jmod, tmod = _MODELS[name]
    jd, jc, jk, *_ = jmod.problem(T)
    td, tc, tk, *_ = tmod.problem(T)
    if nc0:
        jk = [JaxConstraint() for _ in range(T)]
        tk = [Constraint() for _ in range(T)]
    return jax_build_spec(jd, jc, jk), build_spec(td, tc, tk)


def inputs(jspec, T, B, u0, seed, x_scale=0.02):
    """x0 = x1 + x_scale N(0,1), constant controls, states rolled out by the
    JAX model (numpy out)."""
    rng = np.random.default_rng(seed)
    x0 = x_scale * rng.standard_normal((B, jspec.nx))
    us = np.full((B, T - 1, jspec.nu), u0)
    ws = np.zeros((B, T, 0))
    xs = np.asarray(jax.vmap(lambda x, u, w: open_loop_rollout(jspec, x, u, w))(
        jnp.asarray(x0), jnp.asarray(us), jnp.asarray(ws)))
    return xs, us, ws


def solve_both(name, T, u0, nc0=False, B=4, jax_kernel="pallas"):
    """The JAX SL solver (rollouts through ``jax_kernel``, Pallas in
    interpret mode) and the port's ``forward_kernel="pallas"`` path on the
    CPU, from the same numpy inputs."""
    jspec, tspec = specs(name, T, nc0)
    xs, us, ws = inputs(jspec, T, B, u0, seed=5, x_scale=0.3 if nc0 else 0.02)
    jo = JaxOptions(forward_kernel=jax_kernel, **_BASE)
    ref = jax_make_batched_solve_fn(jspec, jo, interpret=True)(
        jnp.asarray(xs), jnp.asarray(us), jnp.asarray(ws))
    fk.SCORE_LAUNCHES.reset()
    sol = make_batched_solve_fn(
        tspec, options_from_fields(
            dataclasses.asdict(jo) | dict(forward_kernel="pallas")),
        device="cpu", dtype=torch.float64,
    )(*batch_from_numpy(xs, us, ws, device="cpu", dtype=torch.float64))
    assert fk.SCORE_LAUNCHES.launches == 0     # CPU: plain versions only
    return ref, solution_to_numpy(sol)


@pytest.mark.parametrize("name,T,u0", [("acrobot", 9, 0.05), ("car", 8, 0.01)])
def test_pallas_path_matches_jax_kernels(name, T, u0):
    ref, out = solve_both(name, T, u0)
    for f in ("iterations", "al_iterations", "status"):
        np.testing.assert_array_equal(out[f], np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ("xs", "us", "duals", "max_violation", "objective"):
        want = np.asarray(getattr(ref, f))
        tol = (TOL_OBJECTIVE if f == "objective" else TOL) * max(
            float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(out[f], want, rtol=0, atol=tol, err_msg=f)


def test_eligibility_rules():
    """Non-uniform per-step dispatch, a user function with an op that does
    not lower to a device function, and constraint-aware acceptance each
    keep the kernels off; forward_kernel="pallas" then raises.  A user
    function of whitelisted ops gets a generated device model."""
    T = 9
    dyn, cost, con, *_ = acrobot.problem(T)
    ub = 8.0
    con_a = Constraint(lambda x, u: torch.cat([u - ub, -u - ub]), 4, 1,
                       indices_inequality=(0, 1))
    con_b = Constraint(lambda x, u: torch.cat([u - 2 * ub, -u - 2 * ub]), 4, 1,
                       indices_inequality=(0, 1))
    mixed = build_spec(dyn, cost, [con_a] * 4 + [con_b] * 4 + con[-1:])
    assert not fk.kernel_eligible(mixed) and fk.device_model(mixed) is None

    mine = Cost(lambda x, u: 0.1 * torch.dot(u, u), 4, 1)
    foreign = build_spec(dyn, [mine] * (T - 1) + cost[-1:], con)
    assert fk.kernel_eligible(foreign)
    assert fk.device_model(foreign).generated is not None
    assert fk.select_kernels(foreign, Options(forward_kernel="pallas", **_BASE), "cpu")
    odd = Cost(lambda x, u: 0.1 * torch.sort(torch.cat([u, x[:1]])).values[0] ** 2, 4, 1)
    unlowered = build_spec(dyn, [odd] * (T - 1) + cost[-1:], con)
    assert fk.kernel_eligible(unlowered) and fk.device_model(unlowered) is None
    assert "aten.sort" in fk.model_reason(unlowered)

    cspec = build_spec(*car.problem(T)[:3])
    pallas = Options(forward_kernel="pallas", **_BASE)
    for spec, o in ((mixed, pallas), (unlowered, pallas),
                    (cspec, dataclasses.replace(
                        pallas, constraint_aware_acceptance=True))):
        with pytest.raises(ValueError, match="stage-uniform"):
            SLOps(spec, o, device="cpu")
        # "auto" never raises: it keeps the loops
        auto = dataclasses.replace(o, forward_kernel="auto")
        assert not fk.select_kernels(spec, auto, "cuda")
    # no constraint rows: the violation filter is off, the kernels serve
    nc0 = build_spec(dyn, cost, [Constraint() for _ in range(T)])
    assert fk.select_kernels(
        nc0, dataclasses.replace(pallas, constraint_aware_acceptance=True), "cpu")


def test_device_model_registry():
    """Registered models are recognised by their own function objects, with
    their parameters; the semantic stage-type grouping keeps them
    stage-uniform.  Any other stage-uniform spec is not the registry's: a
    model generated from its stage functions serves it."""
    T = 9
    aspec = build_spec(*acrobot.problem(T)[:3])
    assert len(np.unique(aspec.con_tidx[: T - 1])) == 1
    assert fk.device_model(aspec) == fk.DeviceModel("acrobot", ())
    dyn, cost, *_ = acrobot.problem(T)
    free = build_spec(dyn, cost, [Constraint() for _ in range(T)])
    assert fk.device_model(free).name == "acrobot_nc0"

    cm = fk.device_model(build_spec(*car.problem(T)[:3]))
    assert cm.name == "car"
    assert cm.params == (1.0, 1.0, 0.0, -5.0, -5.0, 5.0, 5.0, 0.5, 0.5, 0.1 ** 2)
    moved = fk.device_model(build_spec(*car.problem(
        T, x_goal=(2.0, 0.5, 0.1), u_lower=(-3.0, -4.0),
        obstacle_radius=0.2)[:3]))
    assert moved.params == (2.0, 0.5, 0.1, -3.0, -4.0, 5.0, 5.0, 0.5, 0.5,
                            0.2 ** 2)
    # the functions of two different car problems in one spec
    d1, c1, k1, *_ = car.problem(T)
    _, c2, _, *_ = car.problem(T, x_goal=(0.0, 1.0, 0.0))
    two = fk.device_model(build_spec(d1, c1[:-1] + c2[-1:], k1))
    assert two.name.startswith("gen_") and two.generated is not None
    # the same function under another name is not the model's
    renamed = Cost(lambda x, u: acrobot.stage_cost(x, u), 4, 1)
    other = fk.device_model(build_spec(dyn, [renamed] * (T - 1) + cost[-1:],
                                       acrobot.problem(T)[2]))
    assert other.name.startswith("gen_") and other.generated is not None
    assert other.params == () and other.name != two.name


def test_auto_takes_the_loops_on_the_cpu():
    spec = build_spec(*acrobot.problem(9)[:3])
    auto = Options(forward_kernel="auto", **_BASE)
    assert not SLOps(spec, auto, device="cpu").use_kernels
    assert fk.select_kernels(spec, auto, "cuda")
    assert not fk.select_kernels(
        spec, dataclasses.replace(auto, forward_kernel="scan"), "cuda")


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    """A CPU tensor takes the plain version (no launch counted); any other
    non-CUDA device is refused."""
    T, B = 6, 5
    spec = build_spec(*car.problem(T)[:3])
    r = fk.Rollouts(spec, "cpu")
    rng = np.random.default_rng(0)
    g = lambda *s: torch.as_tensor(0.1 * rng.standard_normal(s))
    live = (g(T, 3, B), g(T - 1, 2, B), torch.zeros((T, 0, B), dtype=torch.float64),
            g(T - 1, 2, 3, B), g(T - 1, 2, B), g(T, 5, B).abs(),
            torch.full((T, 5, B), 10.0, dtype=torch.float64))
    before = (fk.SCORE_LAUNCHES.launches, fk.REROLL_LAUNCHES.launches)
    J = fk.score_rollout(r, 3, 4, *live)
    assert torch.equal(J, fk.score_rollout_reference(r, 3, 4, *live))
    alpha = r.alphas(torch.float64, 8)[torch.as_tensor([0, 3, 7, 1, 2])]
    xs, us, Jw, c = fk.winner_reroll(r, alpha, *live)
    assert (fk.SCORE_LAUNCHES.launches, fk.REROLL_LAUNCHES.launches) == before
    # the re-roll at a lane's alpha scores as that candidate does
    Jall = fk.score_rollout_reference(r, 0, 8, *live)
    assert torch.allclose(Jw, Jall[[0, 3, 7, 1, 2], torch.arange(B)],
                          rtol=0, atol=1e-14)
    assert tuple(c.shape) == (T, 5, B) and torch.all(c[-1, 4] == 0)
    assert torch.equal(xs[0], live[0][0])
    meta = tuple(a.to("meta") for a in live)
    with pytest.raises(ValueError, match="unsupported device"):
        fk.score_rollout(r, 0, 2, *meta)
