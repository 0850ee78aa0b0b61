"""The port's time-sharded Riccati recursion (iterativelqr_tpu_torch/
parallel/horizon.py) against the JAX package's (iterativelqr_tpu/parallel/
horizon.py) on the CPU in f64, at tests/test_horizon_shard.py's cases: car
T=24 (an even split over 8 chunks) and acrobot T=25 (padded with identity
elements), the port over eight CPU entries, JAX over its 8-device mesh,
from the same numpy-seeded linearization; then the long-horizon solve end
to end against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import iterativelqr_tpu_torch as P
from iterativelqr_tpu_torch import models
from iterativelqr_tpu_torch.ops import derivatives as dv
from iterativelqr_tpu_torch.ops.assoc import backward_pass_associative
from iterativelqr_tpu_torch.ops.backward import backward_pass_scan
from iterativelqr_tpu_torch.parallel import (default_mesh, make_horizon_sharded_backward,
                                             make_long_horizon_solve_fn, time_sharding)

import iterativelqr_tpu.models as jmodels
from iterativelqr_tpu.core.spec import build_spec as jbuild_spec
from iterativelqr_tpu.ops import derivatives as jdv
from iterativelqr_tpu.parallel.horizon import (
    make_horizon_sharded_backward as jmake_horizon_sharded_backward)

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8
NAMES = ("K", "k", "Qx", "Qu", "p")


def linearization(model, T, u0, seed=0):
    """Both packages' derivative stacks about one open-loop rollout of
    u0 + 0.01 N(0,1) controls from x = 0 (numpy seed)."""
    rng = np.random.default_rng(seed)
    problem = getattr(models, model).problem
    spec = P.build_spec(*problem(T)[:3])
    us = u0 + 0.01 * rng.standard_normal((T - 1, spec.nu))
    xs = [np.zeros(spec.nx)]
    for t in range(T - 1):
        xs.append(spec.dyn_eval[spec.dyn_tidx[t]](
            torch.as_tensor(xs[-1]), torch.as_tensor(us[t]), torch.zeros(0)).numpy())
    xs, ws = np.stack(xs), np.zeros((T, 0))
    port = [torch.as_tensor(a) for a in (xs, us, ws)]
    stacks = (*dv.dynamics_jacobians(spec, *port), *dv.cost_gradients(spec, *port),
              *dv.cost_hessians(spec, *port))
    jspec = jbuild_spec(*getattr(jmodels, model).problem(T)[:3])
    jin = [jnp.asarray(a) for a in (xs, us, ws)]
    jstacks = (*jdv.dynamics_jacobians(jspec, *jin), *jdv.cost_gradients(jspec, *jin),
               *jdv.cost_hessians(jspec, *jin))
    return stacks, jstacks, spec.u_mask


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("model,T,u0", [("car", 24, 0.01), ("acrobot", 25, 0.05)])
def test_horizon_sharded_matches_jax(model, T, u0):
    stacks, jstacks, u_mask = linearization(model, T, u0)
    reg = torch.zeros((), dtype=torch.float64)
    out = make_horizon_sharded_backward(default_mesh(CPU8, "time"), "time")(
        *stacks, torch.as_tensor(u_mask), reg)
    jmesh = JMesh(np.asarray(jax.devices()), ("time",))
    jout = jax.jit(jmake_horizon_sharded_backward(jmesh, "time"))(
        *jstacks, jnp.asarray(u_mask), jnp.zeros(()))
    for name, a, b in zip(NAMES, out[:5], jout[:5]):
        assert rel(a.numpy(), b) <= 1e-10, (name, rel(a.numpy(), b))
    assert bool(out[5]) == bool(jout[5]) is True
    # against the port's unsharded associative scan and its reverse scan
    assoc = backward_pass_associative(*stacks, torch.as_tensor(u_mask), reg)
    scan = backward_pass_scan(*stacks, torch.as_tensor(u_mask), reg)
    for name, a, b, c in zip(NAMES, out[:5], assoc[:5], scan[:5]):
        assert rel(a.numpy(), b.numpy()) <= 1e-10, name
        assert rel(a.numpy(), c.numpy()) <= 1e-8, name


def test_time_sharding_bounds():
    """The chunk bounds the recursion splits time with: ceil(T / n) steps
    each, the last chunks shorter; placement keeps each chunk's rows."""
    ts = time_sharding(default_mesh([torch.device("cpu")] * 3, "time"))
    assert ts.bounds(10) == [(0, 4), (4, 8), (8, 10)]
    chunks = ts.place(torch.arange(10.0))
    assert [c.tolist() for c in chunks] == [[0.0, 1.0, 2.0, 3.0], [4.0, 5.0, 6.0, 7.0],
                                              [8.0, 9.0]]


LONG = dict(verbose=False, record_traces=False, max_iterations=4, max_dual_updates=2,
            scan_unroll=1)


def test_long_horizon_solve_matches_jax():
    """tests/test_horizon_shard.py::test_long_horizon_solve_fn_end_to_end
    at its size: pendulum T=513, the recursion over eight CPU entries,
    against JAX's over its 8-device mesh (same iterations, xs within 1e-10),
    and on the batched form (``.vmap``, two instances) against the port's
    unsharded batched solve; "packed" is refused."""
    from iterativelqr_tpu import Options as JOptions
    from iterativelqr_tpu.models import pendulum as jpendulum
    from iterativelqr_tpu.parallel import make_long_horizon_solve_fn as jmake_long

    T = 513
    spec = P.build_spec(*models.pendulum.problem(T, device="cpu")[:3])
    xs, us, ws = np.zeros((T, 2)), 0.01 * np.ones((T - 1, 1)), np.zeros((T, 0))
    solve = make_long_horizon_solve_fn(spec, P.Options(**LONG),
                                       mesh=default_mesh(CPU8, "time"), device="cpu")
    sol = solve(*(torch.as_tensor(a) for a in (xs, us, ws)))
    jmesh = JMesh(np.asarray(jax.devices()), ("time",))
    jsol = jax.jit(jmake_long(jbuild_spec(*jpendulum.problem(T)[:3]), JOptions(**LONG),
                              mesh=jmesh))(*(jnp.asarray(a) for a in (xs, us, ws)))
    assert int(sol.iterations) == int(jsol.iterations)
    np.testing.assert_allclose(sol.xs.numpy(), np.asarray(jsol.xs), rtol=1e-10, atol=1e-10)
    assert np.isfinite(float(sol.objective))

    Tb = 65
    spec_b = P.build_spec(*models.pendulum.problem(Tb, device="cpu")[:3])
    xs_b = torch.zeros((2, Tb, 2), dtype=torch.float64)
    us_b = 0.01 * torch.ones((2, Tb - 1, 1), dtype=torch.float64)
    us_b[1] += 0.02
    args = (xs_b, us_b, torch.zeros((2, Tb, 0), dtype=torch.float64))
    opts = P.Options(**LONG, backward_pass="associative")
    batched = make_long_horizon_solve_fn(spec_b, opts, mesh=default_mesh(CPU8[:3], "time"),
                                         device="cpu").vmap()(*args)
    ref = P.make_solve_fn(spec_b, opts, device="cpu").vmap()(*args)
    assert torch.equal(batched.iterations, ref.iterations)
    torch.testing.assert_close(batched.xs, ref.xs, rtol=1e-10, atol=1e-10)

    with pytest.raises(ValueError, match="packed"):
        make_long_horizon_solve_fn(spec, P.Options(backward_pass="packed"),
                                   mesh=default_mesh(CPU8, "time"), device="cpu")
