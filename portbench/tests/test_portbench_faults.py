"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have (one card: no exchange between chips to
leave out), and the control, the reference at TF32 in the program's
place, fails at least one of each cell's numbers.  Tiny cells on the CPU
path; the same faults and control run on the card through
``python3 -m portbench.control``."""

import time

import pytest

from helpers_portbench import CELLS, tiny_cells
from portbench import catalog, control, harness


@pytest.mark.parametrize("fault", control.FAULTS)
@pytest.mark.parametrize("w", CELLS)
def test_fault_comes_out_not_correct(w, fault):
    with tiny_cells() as bench, control.planted(fault):
        result, _ = harness.run(bench, w, 4242, 0.5, False, "cpu", time.perf_counter())
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("w", CELLS)
def test_control_fails_a_number(w):
    with tiny_cells() as bench:
        (got,) = control.readings(bench, w, [31], 0.5, device="cpu")
    limits = catalog.checks(w)["limits"]
    assert got["correct"] is True
    assert any(got["control"][k] > limits[k] for k in limits), got["control"]
