"""The port's batch-sharded solve (iterativelqr_tpu_torch/parallel/
shard.py) against the JAX package's (iterativelqr_tpu/parallel/shard.py)
on the CPU in f64, the protocol of tests/test_parallel.py: particle T=11,
B=16 from one numpy seed, the port over a mesh of four CPU entries, JAX
over its 8-device CPU mesh (tests/conftest.py).  On the vmap route xs and
us agree within 1e-10 and the iterations and stats are equal; the SL
route's shards equal the port's unsharded SL solve bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativelqr_tpu_torch as P
from iterativelqr_tpu_torch.models import particle
from iterativelqr_tpu_torch.parallel import (Mesh, batch_stats, default_mesh,
                                             make_sharded_solve_fn, shard_batch)

from iterativelqr_tpu import Options as JOptions
from iterativelqr_tpu.core.spec import build_spec as jbuild_spec
from iterativelqr_tpu.models import particle as jparticle
from iterativelqr_tpu.parallel import (default_mesh as jdefault_mesh,
                                       make_batched_solve_fn as jmake_batched,
                                       make_sharded_solve_fn as jmake_sharded,
                                       shard_batch as jshard_batch)

torch.set_num_threads(1)
T, B = 11, 16
DT = torch.float64
CPU4 = [torch.device("cpu")] * 4
SL = dict(verbose=False, record_traces=False, batched_solver="sl", backward_pass="packed")


def inputs(seed=1, B=B):
    rng = np.random.default_rng(seed)
    xs = np.zeros((B, T, 2))
    xs[:, 0] = rng.uniform(-1.0, 1.0, (B, 2))
    return xs, np.zeros((B, T - 1, 1)), np.zeros((B, T, 0))


def port_spec():
    return P.build_spec(*particle.problem(T, device="cpu")[:3])


def test_sharded_matches_jax_sharded():
    xs, us, ws = inputs()
    mesh = default_mesh(CPU4)
    sol, stats = make_sharded_solve_fn(port_spec(), P.Options(verbose=False), mesh=mesh,
                                       dtype=DT)(*(torch.as_tensor(a) for a in (xs, us, ws)))
    jmesh = jdefault_mesh()
    jsol, jstats = jmake_sharded(jbuild_spec(*jparticle.problem(T)[:3]),
                                 JOptions(verbose=False), mesh=jmesh)(
        *jshard_batch(jmesh, "batch", *(jnp.asarray(a) for a in (xs, us, ws))))
    for f in ("xs", "us"):
        np.testing.assert_allclose(getattr(sol, f).numpy(), np.asarray(getattr(jsol, f)),
                                   rtol=1e-10, atol=1e-10, err_msg=f)
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(jsol.iterations))
    for f in stats._fields:
        np.testing.assert_allclose(float(getattr(stats, f)), float(getattr(jstats, f)),
                                   rtol=1e-10, atol=1e-12, err_msg=f)
    assert float(stats.solved_fraction) == 1.0


@pytest.mark.parametrize("n_entries", [2, 4])
def test_sl_shards_equal_unsharded(n_entries):
    """The SL route over the mesh, its shards advanced trip by trip in
    turns, equals the unsharded SL solve bitwise; the stats reduced across
    shards equal batch_stats of the unsharded solve (counts and maxima
    exactly, means to rounding: they are summed in another order)."""
    spec = port_spec()
    args = [torch.as_tensor(a) for a in inputs(seed=2)]
    ref = P.make_batched_solve_fn(spec, P.Options(**SL), device="cpu", dtype=DT)(*args)
    mesh = default_mesh([torch.device("cpu")] * n_entries)
    sol, stats = make_sharded_solve_fn(spec, P.Options(**SL), mesh=mesh, dtype=DT)(
        *shard_batch(mesh, "batch", *args))
    for f in ("xs", "us", "K", "k", "objective", "max_violation", "iterations", "duals",
              "penalty", "status"):
        assert torch.equal(getattr(sol, f), getattr(ref, f)), f
    want = batch_stats(ref)
    for f in ("solved_fraction", "mean_iterations", "max_violation", "line_search_failures"):
        assert torch.equal(getattr(stats, f), getattr(want, f)), f
    for f in ("mean_violation", "mean_objective"):
        torch.testing.assert_close(getattr(stats, f), getattr(want, f), rtol=1e-13, atol=0)
    sol_only = make_sharded_solve_fn(spec, P.Options(**SL), mesh=mesh, dtype=DT,
                                     with_stats=False)(*args)
    assert torch.equal(sol_only.xs, ref.xs)


def test_batch_that_does_not_divide_is_refused():
    mesh = default_mesh([torch.device("cpu")] * 3)
    solve = make_sharded_solve_fn(port_spec(), P.Options(**SL), mesh=mesh, dtype=DT)
    with pytest.raises(ValueError, match="16 lanes does not divide over the mesh's 3"):
        solve(*(torch.as_tensor(a) for a in inputs()))
    with pytest.raises(ValueError, match="axis"):
        make_sharded_solve_fn(port_spec(), P.Options(**SL), mesh=Mesh(CPU4, "time"), dtype=DT)


def test_shared_parameters_in_axes():
    """tests/test_parallel.py::test_shared_parameters_in_axes: one shared
    parameter trajectory (in_axes=None) through the port's batched entry,
    against JAX's."""
    xs, us, _ = inputs(seed=2, B=4)
    ws = np.zeros((T, 0))
    sol = P.make_batched_solve_fn(port_spec(), P.Options(verbose=False), in_axes=(0, 0, None),
                                  device="cpu", dtype=DT)(
        *(torch.as_tensor(a) for a in (xs, us, ws)))
    jsol = jax.jit(jmake_batched(jbuild_spec(*jparticle.problem(T)[:3]),
                                 JOptions(verbose=False), in_axes=(0, 0, None)))(
        *(jnp.asarray(a) for a in (xs, us, ws)))
    assert sol.xs.shape[0] == 4
    np.testing.assert_allclose(sol.xs.numpy(), np.asarray(jsol.xs), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(jsol.iterations))


def test_default_mesh_needs_a_card_or_devices(monkeypatch):
    """Entry points run on the card unless asked: with no card visible and
    no devices given, default_mesh refuses; a mesh may repeat a device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh()
    mesh = default_mesh(CPU4)
    assert mesh.size == 4 and mesh.axis_name == "batch" and mesh.world_size == 1
