"""BENCHMARK.json against the benchmark's contract, and every entry found
by name under portbench/."""

import json
import re

import pytest

from helpers_portbench import ROOT
from portbench import catalog, inputs, streams

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]) and entry["name"] not in seen
        seen.add(entry["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in catalog.metrics_of(BENCH, "end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert catalog.metrics_of(BENCH, "per_layer", w["name"])


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(w):
    cell = catalog.cell(BENCH, w)
    config = catalog.config(cell["config"])
    assert config["name"] == cell["config"]
    assert catalog.traffic(cell["traffic"])["kind"] in streams.KINDS
    checks = catalog.checks(w)
    assert set(checks["limits"]) >= {"start_gap", "dynamics_gap", "objective_gap", "gain_gap",
                                     "unsolved_share"}
    ref = catalog.reference(config)
    assert (ref.nx, ref.nu) == (config["num_state"], config["num_action"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(catalog.reader(metric))


def test_configuration_counts_match_the_program():
    from iterativelqr_tpu_torch import Options

    for c in BENCH["configs"]:
        config = catalog.config(c["name"])
        assert Options(**config["options"]).num_step_sizes == config["candidates"]
        assert config["reduced"] == c["reduced"] and config["source"] == c["source"]
        assert config["dtype"] in inputs.DTYPES


def test_seeds_past_32_bits_and_distinct_indices():
    a = inputs.seed_of(2 ** 31 + 12345, 0)
    assert a != inputs.seed_of(2 ** 31 + 12345, 1) and 0 <= a < 2 ** 63
    assert inputs.seed_of(5, 0) == inputs.seed_of(5, 0)
