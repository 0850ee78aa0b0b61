"""The plain-torch references against the frozen NumPy oracle, and their
independence from the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers_portbench import ROOT
from portbench import catalog, judge
from portbench.reference import numpy_reference as nr

CONFIGS = ("acrobot_T101", "car_T51")


def lanes(config, B=5, seed=0):
    ref = catalog.reference(config)
    g = np.random.default_rng(seed)
    xs = 0.3 * g.standard_normal((B, config["T"], ref.nx))
    us = 1.0 + 0.5 * g.standard_normal((B, config["T"] - 1, ref.nu))
    return ref, xs, us


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_the_oracle(name):
    config = catalog.config(name)
    ref, xs, us = lanes(config)
    prob = judge.oracle(config)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    nxt = ref.discrete(t(xs[:, :-1]), t(us)).numpy()
    cost = ref.cost(t(xs), t(us)).numpy()
    c = ref.constraints(t(xs), t(us)).numpy()
    cmask = ref.cmask.numpy()
    for b in range(xs.shape[0]):
        want = np.stack([prob.f(xs[b, i], us[b, i]) for i in range(config["T"] - 1)])
        np.testing.assert_allclose(nxt[b], want, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(cost[b], prob.cost(xs[b], us[b]), rtol=1e-13)
        for i, ci in enumerate(prob.con(xs[b], us[b])):
            np.testing.assert_allclose(c[b, i][cmask[i]], ci, rtol=1e-13, atol=1e-13)
            assert not np.any(c[b, i][~cmask[i]])
    ineq = ref.ineq.numpy()
    for i, row in enumerate(prob.ineq):
        assert np.array_equal(ineq[i][cmask[i]], row)


@pytest.mark.parametrize("name", CONFIGS)
def test_recursion_equals_the_oracles_backward_pass(name):
    config = catalog.config(name)
    ref, xs, us = lanes(config, B=1, seed=3)
    prob = judge.oracle(config)
    T, nc = config["T"], ref.nc
    duals, penalty = np.zeros((T, nc)), np.full((T, nc), 10.0)
    stacks = judge.oracle_stacks(prob, ref.cmask.numpy(), xs[0], us[0], duals, penalty)
    K, k = judge.recursion(stacks, 0.0, config["options"])
    want = nr._backward_pass(*stacks, 0.0)
    np.testing.assert_array_equal(K, want[0])
    np.testing.assert_array_equal(k, want[1])


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0000001], dtype=torch.float64)
    assert judge.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]


def test_reference_and_judge_import_nothing_of_the_program():
    code = ("import sys; import portbench.judge, portbench.reference.acrobot, "
            "portbench.reference.car, portbench.inputs, portbench.trace; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'iterativelqr_tpu', 'iterativelqr_tpu_torch'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
