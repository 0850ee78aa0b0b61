"""The time-sharded Riccati recursion across processes
(iterativelqr_tpu_torch/parallel/horizon.py under a process group): two
processes joined with ``torch.distributed`` (gloo, on the CPU), two CPU
"time" mesh entries each, a 4-chunk global mesh, on the pendulum
linearizations of tests/torch_distributed_worker.py's ``HORIZON`` (T=13,
3 lanes, padded with identity elements; T=3, where the second rank holds
only the terminal and an identity element).  Both ranks must return the
same global (K, k, Qx, Qu, p, ok), within 1e-12 of the one-process
function over 4 CPU entries and of the associative scan
(``ops/assoc.py``), in f64.  Imports torch and the port only."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

import iterativelqr_tpu_torch as P
from iterativelqr_tpu_torch.ops.assoc import backward_pass_associative
from iterativelqr_tpu_torch.parallel import default_mesh, make_horizon_sharded_backward

sys.path.insert(0, os.path.dirname(__file__))
import torch_distributed_worker as worker  # noqa: E402

TOL = 1e-12


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_two_process_time_sharding(tmp_path):
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, init, "2", str(rank), str(tmp_path), "cpu",
         "gloo", "5", "2", "horizon"],
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
    assert int(d0["horizon_mesh_size"]) == 4
    for key in d0.files:
        np.testing.assert_array_equal(d0[key], d1[key], err_msg=key)
    one = make_horizon_sharded_backward(default_mesh([torch.device("cpu")] * 4, "time"), "time")
    for T, lanes in worker.HORIZON:
        stacks, um, reg = worker.horizon_case(P, T, lanes, "cpu")
        for ref in (one(*stacks, um, reg), backward_pass_associative(*stacks, um, reg)):
            for name, want in zip(worker.HORIZON_NAMES, ref):
                got = d0[f"horizon_T{T}_{name}"]
                assert got.shape == tuple(want.shape), (T, name)
                if name == "ok":
                    assert got.all() and bool(want.all()), T
                else:
                    assert _rel(got, want.numpy()) <= TOL, (T, name, _rel(got, want.numpy()))
