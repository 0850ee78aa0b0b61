"""A tiny run of each cell's path on the CPU (the test-only CPU path: the
command itself refuses to run without a card), in a process of its own:
the result holds exactly the contract's keys, ``checks`` last; no module of
JAX or the JAX package was loaded; the command refuses without a card."""

import json
import subprocess
import sys

import pytest

from helpers_portbench import CELLS, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
RUN = """
import json, sys, time
sys.path.insert(0, {tests!r})
from helpers_portbench import tiny_cells
from portbench import harness
with tiny_cells() as bench:
    result, info = harness.run(bench, {w!r}, 2 ** 31 + 77, 0.5, {traced}, "cpu", time.perf_counter())
print(json.dumps({{"result": result, "forbidden": harness.forbidden_modules()}}))
"""


@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("w", CELLS)
def test_tiny_run(w, traced):
    code = RUN.format(tests=str(ROOT / "portbench" / "tests"), w=w, traced=traced)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    result = got["result"]
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if traced else [])
    assert list(result) == keys + ["checks"]
    assert result["correct"] is True and result["failed"] == 0
    section = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in BENCH[section] if w in m.get("workloads", [w])}
    if w not in [c["name"] for c in BENCH["workloads"]]:
        names = {"setup_s"} if not traced else set()
    assert set(result["metrics"]) <= names
    if not traced:
        assert set(result["metrics"]) == names
    else:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0
    for value, limit in result["checks"].values():
        assert value <= limit


def test_command_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "car.sweep",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
