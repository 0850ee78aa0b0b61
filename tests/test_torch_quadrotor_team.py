"""The team of three quadrotors of tests/torch_user_problems.py ((n, m) =
(36, 12): three models/quadrotor.py quadrotors planned as one system, the
thrust box and the pairwise separations as inequality rows, the terminal
goal as an equality), written once for both packages: its derivative stacks
per t and per lane against the JAX package's to 1e-12 (the same f64
operations), its generated device program (what K3/K4 run on the card)
against the torch stage functions, and its SL solve on the port's CPU path
(the plain versions of the recursion at (36, 12), past n + m = 32, and of
K3/K4 on the generated model) against the JAX package's vmap-route solve of
the same inputs, compiled once: equal iterations on every lane, objectives
within 1e-8 relative; and the ring of step tiles K3/K4 take at the team's
dims beside today's models'.  The solve runs T=11 (half a second), where the
starts sit R_SOLVE = 0.25 from the centre: the rotorcraft cannot cross
TEAM_R = 0.75 in that time (a sideways move needs the frame tilted first),
and closer starts with the inputs' 0.1 N(0, 1) noise begin inside the
separation."""

import concurrent.futures
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativelqr_tpu as jilqr
import iterativelqr_tpu_torch as P
from iterativelqr_tpu.parallel.batch import make_batched_solve_fn as jmake_batched
from iterativelqr_tpu_torch.ops import device_functions as df
from iterativelqr_tpu_torch.ops import packed_backward as pk
from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk
from test_torch_spec import _jax_eval, _torch_eval
from torch_user_problems import quadrotor_team, quadrotor_team_inputs

torch.set_num_threads(1)

ATOL = 1e-12
T_SOLVE, B_SOLVE, R_SOLVE = 11, 4, 0.25
# the tuned preset's AL options (bench.py, chip_smoke.py::TUNED), the
# options of the team's solve on the card
TUNED = dict(verbose=False, initial_constraint_penalty=1000.0, min_step_size=4.0e-3,
             early_round_iteration_cap=20)


@pytest.fixture(scope="module")
def specs():
    return quadrotor_team(jilqr, jnp, T=5), quadrotor_team(P, torch, T=5)


@pytest.fixture(scope="module")
def batch():
    """States about the three hovers with angles up to about 0.5 rad and
    the rotorcraft close enough that separation rows are active; thrusts
    about hover, some outside the box."""
    B, T = 4, 5
    xs, us, ws = quadrotor_team_inputs(B, T, seed=7)
    rng = np.random.default_rng(8)
    xs = xs + 0.3 * rng.standard_normal(xs.shape)
    xs[:, :, 12:15] = xs[:, :, 0:3] + 0.2 * rng.standard_normal((B, T, 3))
    us = np.concatenate([us, us[:, -1:]], axis=1)   # a control row at every t
    us = us + 2.0 * rng.standard_normal(us.shape)
    return xs, us, ws


def test_layout_matches(specs):
    jspec, tspec = specs
    assert (tspec.nx, tspec.nu, tspec.nc) == (jspec.nx, jspec.nu, jspec.nc) == (36, 12, 36)
    np.testing.assert_array_equal(tspec.ineq_mask, jspec.ineq_mask)
    np.testing.assert_array_equal(tspec.c_mask, jspec.c_mask)
    assert int(tspec.ineq_mask[0].sum()) == 27 and not tspec.ineq_mask[-1].any()
    # past n + m = 32: the recursion takes the tall template on the card
    assert pk.riccati_plan(36, 12, torch.float32).tall


@pytest.mark.parametrize("family", ["dyn_eval", "dyn_jac", "cost_eval", "cost_grad",
                                    "cost_hess", "con_eval", "con_jac"])
def test_stacks_match_jax(specs, batch, family):
    """Every stage type over its own timesteps: fx, fu; gx, gu; gxx, guu,
    gux; cx, cu (and the values), per t and lane, to 1e-12."""
    jspec, tspec = specs
    kind = family.split("_")[0]
    groups = {"dyn": jspec.dyn_groups, "cost": jspec.cost_groups,
              "con": jspec.con_groups}[kind]
    for k, rows in enumerate(groups):
        a = _jax_eval(getattr(jspec, family)[k], rows, *batch)
        b = _torch_eval(getattr(tspec, family)[k], rows, *batch)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_allclose(y, x, rtol=0, atol=ATOL, err_msg=f"{family}[{k}]")


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_generated_program_equals_the_torch_functions(specs, batch, dtype, tol):
    """The team gets a generated device model (no registered model), with
    27 stage rows (all inequalities) and 36 terminal rows; each of its five
    programs, interpreted with torch ops, equals the torch stage function
    on every lane (f64 to 1e-12, f32 to 1e-5 relative)."""
    tspec = specs[1]
    model = fk.device_model(tspec, "cpu")
    assert model is not None and model.generated is not None, fk.model_reason(tspec, "cpu")
    gen = model.generated
    assert (gen.nx, gen.nu, gen.nc_stage, gen.nc_term) == (36, 12, 27, 36)
    assert gen.ineq == tuple(range(27)) and gen.ineq_T == ()
    xs, us, _ = batch
    x = torch.as_tensor(xs[:, 1].T, dtype=dtype)
    u = torch.as_tensor(us[:, 1].T, dtype=dtype)
    w = torch.zeros((0, x.shape[1]), dtype=dtype)
    slots = ("dyn", "stage_cost", "term_cost", "stage_con", "term_con")
    for slot, prog, o in zip(slots, gen.programs, df.stage_objects(tspec)):
        uu = torch.zeros_like(u) if slot.startswith("term") else u
        want = torch.stack([o._fn(x[:, b], uu[:, b], w[:, b]).reshape(-1)
                            for b in range(x.shape[1])], dim=-1)
        got = df.run(prog, x, uu, w)
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= tol * scale, slot
    # the batch holds an active separation row on some lane
    assert float(df.run(gen.programs[3], x, u, w)[24:].max()) > 0.0


def _inputs():
    return quadrotor_team_inputs(B_SOLVE, T_SOLVE, seed=1, radius=R_SOLVE)


def _jax_solution():
    """The JAX package's vmap-route solve of ``_inputs()`` (iterations,
    objective, xs), traced, compiled and run in a worker process of its
    own (the tests' JAX settings: CPU, f64, the compile cache), beside the
    port's solve in this one: its trace alone took 25-33 s of Python.  Its
    backward pass is named: at B=4 > T // 7 the vmap rule of "auto" takes
    the reverse scan too (``ops/backward.py::_assoc_wins``), so the program
    is the same, but "auto" also traces the associative scan for a single
    instance (8 of the 33 s the trace took)."""
    from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    setup_compile_cache("cpu")
    spec = quadrotor_team(jilqr, jnp, T=T_SOLVE, radius=R_SOLVE)
    fn = jmake_batched(spec, jilqr.Options(**TUNED, backward_pass="scan"))
    jsol = jax.jit(fn)(*(jnp.asarray(a) for a in _inputs()))
    return {f: np.asarray(getattr(jsol, f)) for f in ("iterations", "objective", "xs")}


def test_sl_solve_matches_jax():
    """The SL route, f64, B=4, T=11 from the three hovers, the tuned
    preset's options, with the plain versions of the tall recursion and of
    K3/K4 on the generated model (forward_kernel="pallas"): equal
    iterations lane by lane and objectives within 1e-8 relative of the JAX
    package's vmap-route solve (traces on), and the trajectories within
    1e-8 of the largest value; the rotorcraft left their starts."""
    spec = quadrotor_team(P, torch, T=T_SOLVE, radius=R_SOLVE)
    opts = P.Options(**TUNED, record_traces=False, batched_solver="sl", forward_kernel="pallas")
    inputs = _inputs()
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        jax_side = pool.submit(_jax_solution)
        sol = P.make_batched_solve_fn(spec, opts, device="cpu", dtype=torch.float64)(
            *(torch.as_tensor(a) for a in inputs))
        want = jax_side.result(timeout=600)
    np.testing.assert_array_equal(sol.iterations.numpy(), want["iterations"])
    np.testing.assert_allclose(sol.objective.numpy(), want["objective"], rtol=1e-8, atol=0)
    np.testing.assert_allclose(sol.xs.numpy(), want["xs"], rtol=0,
                               atol=1e-8 * np.abs(want["xs"]).max())
    moved = np.abs(sol.xs.numpy()[:, -1] - inputs[0][:, -1]).max(axis=-1)
    assert (moved > 0.1).any()


RING_BUDGET = 64 * 1024   # bytes of tiles K3/K4's ring aims for (kRingBudget)


def _ring_rule(nx, nu, nw, nc_stage, stream, dtype):
    """csrc/sl_rollout.cuh's ring rule (``ScoreTile``) for a model's dims:
    (tiles, bytes of shared memory a block).  A tile holds a step's xbar,
    ubar, w, K, k and the stage rows of duals and penalty for 32 lanes; the
    ring holds as many tiles as fit RING_BUDGET bytes, at least 2 (1 where
    two pass a block's shared memory) and at most 8, each with a full and
    an empty mbarrier; (0, 0) where the model loads its step inputs in the
    step (``stream`` false, or one tile past a block)."""
    size = torch.finfo(dtype).bits // 8
    tile = (nx + nu + nw + nu * nx + nu + 2 * nc_stage) * 32 * size
    if not stream or tile + 16 > pk.SHARED_MAX:
        return 0, 0
    floor = 2 if 2 * (tile + 16) <= pk.SHARED_MAX else 1
    depth = min(max(RING_BUDGET // tile, floor), 8)
    return depth, depth * tile + 16 * depth


@pytest.mark.parametrize("dims,dtype,ring", [
    # today's streaming models keep their rings (chip_smoke.py's phase 3b
    # reports): acrobot, cartpole, the quadrotor
    ((4, 1, 0, 0), torch.float64, (8, 20608)),
    ((4, 1, 0, 0), torch.float32, (8, 10368)),
    ((4, 1, 0, 2), torch.float64, (8, 28800)),
    ((4, 1, 0, 2), torch.float32, (8, 14464)),
    ((12, 4, 0, 8), torch.float64, (3, 64560)),
    ((12, 4, 0, 8), torch.float32, (6, 64608)),
    # the team: 546 slots a lane, 2 tiles in f32 and 1 in f64 (two f64
    # tiles, 279,584 B, pass a block's 232,448)
    ((36, 12, 0, 27), torch.float32, (2, 139808)),
    ((36, 12, 0, 27), torch.float64, (1, 139792)),
])
def test_rollout_ring_rule(dims, dtype, ring):
    """K3/K4's ring (csrc/sl_rollout.cuh::ScoreTile, mirrored by
    _ring_rule): as many tiles as fit 64 KB, at least 2 where two fit a
    block and 1 where they do not, at most 8; every ring fits a block.  A
    model that loads its step inputs in the step, or whose one tile passes
    a block, has none.  The card tests hold the libraries' own reports
    (``sl_forward_kernel.rollout_ring``) to these rings."""
    assert _ring_rule(*dims, True, dtype) == ring
    assert ring[1] <= pk.SHARED_MAX
    assert _ring_rule(*dims, False, dtype) == (0, 0)
    assert _ring_rule(48, 16, 0, 32, True, torch.float64) == (0, 0)


def test_inequality_masks_hold_64_rows(specs):
    """The generated header's inequality masks are 64-bit (the team's 27
    stage rows set bits 0-26; its 36 terminal rows are equalities, read
    past bit 31 by the kernels' AL term); a model with an inequality row
    past row 63 is refused by name."""
    header = df.generate(specs[1]).header
    assert f"INEQ_STAGE = {2 ** 27 - 1}ull, INEQ_TERM = 0ull" in header
    rows = P.Constraint(lambda x, u: torch.cat([x, u]).repeat(22)[:65] - 1.0, 2, 1,
                        indices_inequality=range(65))
    dyn = P.Dynamics(lambda x, u: x + 0.1 * torch.stack([x[1], u[0]]), 2, 1)
    cost = P.Cost(lambda x, u: x @ x + u @ u, 2, 1)
    term = P.Cost(lambda x, u: x @ x, 2, 0)
    spec = P.build_spec([dyn] * 3, [cost] * 3 + [term], [rows] * 3 + [P.Constraint()])
    with pytest.raises(df.Refused, match="past row 63"):
        df.generate(spec)
