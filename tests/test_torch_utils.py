"""The port's checkpoint and profiling utilities (iterativelqr_tpu_torch/
utils/): the ports of tests/test_utils.py's checkpoint tests, the same
files read by both packages' ``load`` (the JAX package's ``.npz`` route),
and the profiler's trace, named ranges and timer."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativelqr_tpu_torch as P
from iterativelqr_tpu_torch.core.mpc import MPCState
from iterativelqr_tpu_torch.models import particle
from iterativelqr_tpu_torch.utils import checkpoint, profiling

from iterativelqr_tpu.core.mpc import MPCState as JMPCState
from iterativelqr_tpu.utils import checkpoint as jcheckpoint

torch.set_num_threads(1)


def mpc_state():
    """tests/test_utils.py's state."""
    return MPCState(xs=torch.arange(6.0, dtype=torch.float64).reshape(3, 2),
                    us=torch.ones((2, 1), dtype=torch.float64),
                    K=torch.zeros((2, 1, 2), dtype=torch.float64),
                    duals=torch.zeros((3, 2), dtype=torch.float64),
                    penalty=torch.full((3, 2), 10.0, dtype=torch.float64))


def zeros_like_state(s):
    return MPCState(*(torch.zeros_like(getattr(s, f)) for f in
                      ("xs", "us", "K", "duals", "penalty")))


def test_checkpoint_roundtrip_mpc_state(tmp_path):
    state = mpc_state()
    p = checkpoint.save(os.path.join(str(tmp_path), "ckpt"), state)
    assert p.endswith(".npz")
    restored = checkpoint.load(p, zeros_like_state(state))
    for a, b in zip(checkpoint.tree_leaves(restored), checkpoint.tree_leaves(state)):
        assert torch.equal(a, b) and a.dtype == b.dtype and a.device == b.device


def test_checkpoint_roundtrip_solution(tmp_path):
    """A Solution of a small particle solve, with bool and int leaves,
    and a tuple of tensors beside it; ``load`` follows the template's
    dtype."""
    T = 7
    spec = P.build_spec(*particle.problem(T, device="cpu")[:3])
    sol = P.make_batched_solve_fn(spec, P.Options(record_traces=False), device="cpu",
                                  dtype=torch.float64)(
        torch.zeros((2, T, 2), dtype=torch.float64), torch.zeros((2, T - 1, 1), dtype=torch.float64),
        torch.zeros((2, T, 0), dtype=torch.float64))
    state = (sol, (sol.xs[0], sol.us[0]))
    p = checkpoint.save(os.path.join(str(tmp_path), "sol.npz"), state)
    like = (P.Solution(**{f: torch.zeros_like(getattr(sol, f)) for f in sol.__dataclass_fields__}),
            (torch.zeros_like(sol.xs[0]), torch.zeros_like(sol.us[0])))
    restored = checkpoint.load(p, like)
    for a, b in zip(checkpoint.tree_leaves(restored), checkpoint.tree_leaves(state)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert restored[0].status.dtype == torch.bool
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load(p, like[1])


def test_checkpoint_files_cross_load(tmp_path, monkeypatch):
    """An MPCState saved by either package loads in the other (the JAX
    package's ``.npz`` route: the same index keys, the same field order)."""
    monkeypatch.setattr(jcheckpoint, "_ocp", None)
    state = mpc_state()
    p = checkpoint.save(os.path.join(str(tmp_path), "port"), state)
    jlike = JMPCState(*(jnp.zeros(tuple(getattr(state, f).shape)) for f in
                        ("xs", "us", "K", "duals", "penalty")))
    loaded = jcheckpoint.load(p, jlike)
    for f in ("xs", "us", "K", "duals", "penalty"):
        np.testing.assert_array_equal(np.asarray(getattr(loaded, f)), getattr(state, f).numpy())
    jp = jcheckpoint.save(os.path.join(str(tmp_path), "jax"),
                          JMPCState(*(jnp.asarray(getattr(state, f).numpy()) for f in
                                      ("xs", "us", "K", "duals", "penalty"))))
    restored = checkpoint.load(jp, zeros_like_state(state))
    for a, b in zip(checkpoint.tree_leaves(restored), checkpoint.tree_leaves(state)):
        assert torch.equal(a, b)


def test_checkpoint_numeric_leaf_order(tmp_path):
    """Leaves restore in numeric order past 10,000 leaves with unpadded
    keys (a lexicographic sort puts leaf_10000 before leaf_2000)."""
    n = 10_001
    path = os.path.join(str(tmp_path), "mixed.npz")
    np.savez(path, **{f"leaf_{i}": np.asarray(float(i)) for i in range(n)})
    restored = checkpoint.load(path, [torch.zeros((), dtype=torch.float64)] * n)
    assert torch.equal(torch.stack(restored), torch.arange(float(n), dtype=torch.float64))


def test_checkpoint_directory_refused(tmp_path):
    d = os.path.join(str(tmp_path), "dir_ckpt")
    os.makedirs(d)
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.load(d, zeros_like_state(mpc_state()))


def test_profiling_trace_annotate_timed(tmp_path):
    """``trace`` writes a Chrome trace holding the ``annotate`` range, named
    ``ilqr.<name>``, and the span's record lies inside it on the trace's
    clock; ``timed`` returns seconds a call."""
    x = torch.ones(64, 64)
    profiling.drain()
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("ilqr_stage"):
            (x @ x).sum()
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.json"))
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    names = {e.get("name") for e in events}
    assert "ilqr.ilqr_stage" in names
    assert any(e.key == "ilqr.ilqr_stage" for e in prof.key_averages())
    (rng,) = [e for e in events if e.get("name") == "ilqr.ilqr_stage" and e.get("ph") == "X"]
    (rec,) = profiling.drain()
    assert rec["name"] == "ilqr_stage" and rec["device_ms"] is None
    # the record's host interval (Unix-epoch ns) inside the trace's range
    # (microseconds after the trace's base), to the trace's rounding
    base = doc["baseTimeNanoseconds"]
    t0, t1 = float(rng["ts"]), float(rng["ts"]) + float(rng["dur"])
    start, end = ((rec[k] - base) / 1e3 for k in ("host_start_ns", "host_end_ns"))
    assert t0 - 1.0 <= start <= end <= t1 + 1.0
    t = profiling.timed(lambda a: a @ a, x, reps=3, warmup=1)
    assert isinstance(t, float) and t > 0.0
