"""The port's sharded solve across processes (iterativelqr_tpu_torch/
parallel/shard.py), the protocol of tests/test_distributed.py: two
processes joined with ``torch.distributed`` (gloo, on the CPU), two CPU
mesh entries each, a 4-entry global mesh, particle T=7, B=8.  Both ranks
must return the same global Solution and stats, equal bitwise to a
one-process solve of the port and within 1e-10 of the JAX package's
batched solve, on the vmap and the SL route.  Also the port of
tests/test_utils.py's ``distributed_initialize`` test."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativelqr_tpu_torch as P
from iterativelqr_tpu_torch.models import particle
from iterativelqr_tpu_torch.parallel import batch_stats, shard

from iterativelqr_tpu import Options as JOptions
from iterativelqr_tpu.core.spec import build_spec as jbuild_spec
from iterativelqr_tpu.models import particle as jparticle
from iterativelqr_tpu.parallel.batch import make_batched_solve_fn as jmake_batched

sys.path.insert(0, os.path.dirname(__file__))
import torch_distributed_worker as worker  # noqa: E402

T, B = 7, 8


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_solve(tmp_path):
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, init, "2", str(rank), str(tmp_path), "cpu",
         "gloo", str(T), str(B), "vmap,sl"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for rank in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"

    d0, d1 = np.load(tmp_path / "rank0.npz"), np.load(tmp_path / "rank1.npz")
    assert int(d0["world_size"]) == 2 and int(d0["mesh_size"]) == 4
    for key in d0.files:
        np.testing.assert_array_equal(d0[key], d1[key], err_msg=key)

    spec = P.build_spec(*particle.problem(T, device="cpu")[:3])
    xs, us, ws = (torch.as_tensor(a) for a in worker.global_batch(spec, T, B))
    jspec = jbuild_spec(*jparticle.problem(T)[:3])
    for route, kw in worker.ROUTES.items():
        # one process, one device: the same lanes bitwise
        ref = P.make_batched_solve_fn(spec, P.Options(**kw), device="cpu",
                                      dtype=torch.float64)(xs, us, ws)
        for f in ("xs", "us", "iterations", "max_violation", "objective"):
            np.testing.assert_array_equal(d0[f"{route}_{f}"], getattr(ref, f).numpy(),
                                          err_msg=f"{route} {f}")
        stats = batch_stats(ref)
        for f in ("solved_fraction", "mean_iterations", "max_violation",
                  "line_search_failures"):
            assert float(d0[f"{route}_stats_{f}"]) == float(getattr(stats, f)), (route, f)
        for f in ("mean_violation", "mean_objective"):   # summed in another order
            np.testing.assert_allclose(d0[f"{route}_stats_{f}"], getattr(stats, f).numpy(),
                                       rtol=1e-12, err_msg=f"{route} {f}")
        assert float(d0[f"{route}_stats_solved_fraction"]) == 1.0
        # the JAX package's batched solve of the same batch
        jsol = jax.jit(jmake_batched(jspec, JOptions(**kw), interpret=True))(
            *(jnp.asarray(a.numpy()) for a in (xs, us, ws)))
        np.testing.assert_allclose(d0[f"{route}_xs"], np.asarray(jsol.xs), rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(d0[f"{route}_iterations"], np.asarray(jsol.iterations))


def test_distributed_initialize_reraises_genuine_failures(monkeypatch):
    """tests/test_utils.py::test_distributed_initialize_reraises_genuine_
    failures: a failure to join propagates; an initialized group makes the
    call a no-op."""
    def boom(**kwargs):
        raise RuntimeError("connection refused: tcp://10.0.0.1:1234")

    monkeypatch.setattr(shard.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(shard.dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="connection refused"):
        shard.distributed_initialize(init_method="tcp://10.0.0.1:1234", world_size=2, rank=0)

    def unreachable(**kwargs):
        raise AssertionError("an initialized group must not be initialized again")

    monkeypatch.setattr(shard.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(shard.dist, "init_process_group", unreachable)
    shard.distributed_initialize()
