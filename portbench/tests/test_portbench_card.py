"""On the card: one short run of each cell through the command, correct.
Skips where there is no CUDA card (decided in the fixture)."""

import json
import subprocess
import sys

import pytest

from helpers_portbench import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_short_run_on_the_card(card, w):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", w, "--seed",
                          "2147483701", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
