"""The port's batch-sharded example sweeps (iterativelqr_tpu_torch/
examples/pod_sweep.py and batched_sweep.py) on the CPU: each runs with
``--device cpu`` and prints what its JAX twin prints.  pod_sweep takes its
twin's ``--quick`` (256 instances) at ``--horizon 21`` (of 51); the
batched sweep 8 instances (of 512) at ``--horizon 11`` (of 51)."""

import re

import torch

from iterativelqr_tpu_torch.examples import batched_sweep, pod_sweep

torch.set_num_threads(1)


def test_pod_sweep_quick(capsys):
    results = pod_sweep.main(["--quick", "--horizon", "21", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "single-process mode" in out
    for name in ("acrobot", "car"):
        m = re.search(rf"{name}: 128 instances in [\d.]+s \(\d+ solves/s, \d+ /s/device\), "
                      r"solved ([\d.]+)", out)
        assert m and float(m.group(1)) == 1.0, out
        sol, stats, wall = results[name]
        assert sol.xs.shape[:2] == (128, 21) and wall > 0.0
        assert float(stats.solved_fraction) == 1.0


def test_batched_sweep(capsys):
    sol, stats = batched_sweep.main(["--batch", "8", "--horizon", "11", "--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("1 cpu device(s); batch 8", "first solve:", "steady state:",
                 "solved fraction: 1.000", "mean iterations:"):
        assert line in out, out
    assert sol.xs.shape == (8, 11, 4) and float(stats.solved_fraction) == 1.0
