"""One line search through the port's rollout path (forward_kernel="pallas",
plain versions on the CPU) against the JAX package's Pallas rollout kernels
in interpret mode, with random non-converged gains at B=128 (the unit case
of tests/test_sl_forward_kernel.py), in f64 to 1e-10; and the kernel-free
acrobot (nc=0) solve.

Kept apart from tests/test_torch_sl_forward_kernel.py so that the two
files' JAX interpret-mode compilations run on different test workers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.ops.sl_ops import SLOps as JaxSLOps
from iterativelqr_tpu.ops.sl_ops import from_sl as jax_from_sl
from iterativelqr_tpu.ops.sl_ops import to_sl as jax_to_sl
from iterativelqr_tpu_torch import Options
from iterativelqr_tpu_torch.ops.sl_ops import SLOps, from_sl, to_sl
from test_torch_sl_forward_kernel import _BASE, TOL, inputs, solve_both, specs

torch.set_num_threads(1)

T, B = 9, 128


def _case(name, seed=11):
    """Live line-search arrays: states rolled out from constant controls,
    random gains, duals and penalties, and a negative slope."""
    jspec, tspec = specs(name, T)
    xs, us, ws = inputs(jspec, T, B, 0.05, seed=seed)
    rng = np.random.default_rng(seed + 1)
    K = 0.1 * rng.standard_normal((B, T - 1, jspec.nu, jspec.nx))
    k = 0.1 * rng.standard_normal((B, T - 1, jspec.nu))
    duals = 0.5 * rng.standard_normal((B, T, jspec.nc))
    if name == "car":
        # inequality rows with lam = 0 on half the lanes: there the inactive
        # rule (c < 0, lam == 0) drops the quadratic term; a control far
        # past its bound on some lanes makes those rows active
        duals = np.abs(duals) * (rng.uniform(size=(B, 1, 1)) < 0.5)
        us[::5] = 6.0
        k[::7] *= 100.0
    pen = np.full((B, T, jspec.nc), 10.0)
    slope = -np.abs(rng.standard_normal(B))
    return jspec, tspec, (xs, us, ws, K, k, duals, pen, slope)


def _port_line_search(tops, arrays):
    xs, us, ws, K, k, duals, pen, slope = (
        to_sl(torch.as_tensor(np.array(a))) for a in arrays)
    J, c = tops.al_objective(xs, us, ws, duals, pen)
    return tops.line_search(xs, us, ws, K, k, slope, J, c, duals, pen)


@pytest.mark.parametrize("name,grid", [("acrobot", "tuned8"),
                                       ("car", "parity17")])
def test_line_search_unit_matches_jax_kernels(name, grid):
    """Scores (head block, and the tail block on the lanes the head leaves
    unsettled), winner and re-rolled trajectory."""
    jspec, tspec, arrays = _case(name)
    kw = dict(min_step_size=4e-3) if grid == "tuned8" else {}
    jops = JaxSLOps(jspec, JaxOptions(forward_kernel="pallas", **_BASE, **kw),
                    interpret=True)
    tops = SLOps(tspec, Options(forward_kernel="pallas", **_BASE, **kw),
                 device="cpu", dtype=torch.float64)
    assert jops._fk_score is not None and tops.use_kernels
    xs, us, ws, K, k, duals, pen, slope = (
        jax_to_sl(jnp.asarray(a), B // 128) for a in arrays)
    Jj, cj = jops.al_objective(xs, us, ws, duals, pen)
    ref = jax.jit(jops.line_search)(xs, us, ws, K, k, slope, Jj, cj, duals, pen)
    out = _port_line_search(tops, arrays)
    for f, a, b in zip(("xs", "us", "J", "c", "status", "step"), ref, out):
        np.testing.assert_allclose(from_sl(b).numpy(), np.asarray(jax_from_sl(a)),
                                   rtol=TOL, atol=TOL, err_msg=f)
    status, step = from_sl(out[4]).numpy(), from_sl(out[5]).numpy()
    assert status.any()
    if name == "car":
        c = from_sl(out[3]).numpy()
        assert (c[:, :-1] > 0).any() and (c[:, :-1] < 0).any()
        if Options(**_BASE).num_step_sizes > 8:
            assert (status & (step < 0.5 ** 7)).any() or not status.all()


@pytest.mark.parametrize("name", ["acrobot", "car"])
@pytest.mark.parametrize("seed", [11, 23])
def test_pallas_and_scan_paths_agree_exactly_on_the_cpu(name, seed):
    """On CPU tensors both selector values run the same plain loops: one
    line search gives identical results."""
    _, tspec, arrays = _case(name, seed)
    outs = [
        _port_line_search(SLOps(tspec, Options(forward_kernel=m, **_BASE),
                                device="cpu", dtype=torch.float64), arrays)
        for m in ("pallas", "scan")
    ]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_nc0_solve_matches_jax():
    """No constraint rows (pure iLQR, the JAX test's pendulum nc=0 case, on
    acrobot): the port's kernel path against the JAX SL solver's scan
    rollouts (tests/test_sl_forward_kernel.py pins the JAX package's Pallas
    nc=0 path to its scan path)."""
    ref, out = solve_both("acrobot", 8, 0.2, nc0=True, B=3, jax_kernel="scan")
    np.testing.assert_array_equal(out["iterations"], np.asarray(ref.iterations))
    want = np.asarray(ref.xs)
    np.testing.assert_allclose(out["xs"], want, rtol=0,
                               atol=TOL * max(float(np.abs(want).max()), 1.0))
