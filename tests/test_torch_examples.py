"""The port's examples (iterativelqr_tpu_torch/examples/) on the CPU: each
runs with ``--device cpu`` and prints what its JAX twin in examples/
prints.  Sizes: the twin's own where it is quick (particle, mpc_demo,
mpc_farm, sensitivity_demo); otherwise a horizon cut named here (car T=21
of 51, acrobot T=11 of 51, ddp_acrobot T=8 of 101, long_horizon T=65 of
1025).  The particle and the sensitivity demo are held to their JAX twins'
printed numbers.  tests/test_torch_examples_sweep.py runs the sweeps."""

import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from iterativelqr_tpu_torch.examples import (acrobot, car, ddp_acrobot, long_horizon,
                                             mpc_demo, mpc_farm, sensitivity_demo)

torch.set_num_threads(1)
NUM = r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?"


def run_jax_twin(name, capsys):
    runpy.run_path(f"examples/{name}.py", run_name="__main__")
    return capsys.readouterr().out


def test_particle_module_matches_jax_twin(capsys):
    """``python -m`` runs the example; its violation equals the twin's."""
    out = subprocess.run([sys.executable, "-m", "iterativelqr_tpu_torch.examples.particle",
                          "--device", "cpu"], capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert "terminal state:" in out and "goal:" in out
    viol = float(re.search(rf"max violation: ({NUM})", out).group(1))
    twin = float(re.search(rf"max violation: ({NUM})", run_jax_twin("particle", capsys)).group(1))
    assert viol <= 5e-3
    np.testing.assert_allclose(viol, twin, rtol=1e-6)


def test_sensitivity_demo_matches_jax_twin(capsys):
    sensitivity_demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    twin = run_jax_twin("sensitivity_demo", capsys)
    rows = lambda text: np.array(re.findall(rf"dJ/dw = \[\s*({NUM}),\s*({NUM})\]", text), float)
    assert rows(out).shape == (11, 2)
    np.testing.assert_allclose(rows(out), rows(twin), atol=2e-4)
    last = lambda text: text.strip().splitlines()[-1]
    assert last(out) == last(twin)
    assert float(re.search(rf"solved: violation ({NUM})", out).group(1)) <= 5e-3


@pytest.mark.parametrize("module,argv,lines", [
    (car, ["--horizon", "21"], ("terminal state:", "closest obstacle approach:",
                                "max violation:")),
    (acrobot, ["--horizon", "11"], ("terminal state:", "terminal error:")),
    (ddp_acrobot, ["--horizon", "8"], ("Gauss-Newton  objective", "full DDP      objective")),
    (mpc_demo, [], ("step", "final measured state:")),
    (mpc_farm, [], ("cold solve: mean iters", "step 11:",
                    "farm ok: every plan feasible at every step")),
    (long_horizon, ["--horizon", "65"], ("objective:", "max violation:", "iterations:")),
], ids=["car", "acrobot", "ddp_acrobot", "mpc_demo", "mpc_farm", "long_horizon"])
def test_example_prints_what_its_twin_prints(module, argv, lines, capsys):
    module.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, (line, out[-2000:])
    if module in (car, acrobot, long_horizon):
        key = "terminal error:" if module is acrobot else "max violation:"
        assert float(re.search(rf"{key}\s*({NUM})", out).group(1)) <= 5e-3
    if module is ddp_acrobot:
        for v in re.findall(rf"violation ({NUM})", out):
            assert float(v) <= 5e-3
