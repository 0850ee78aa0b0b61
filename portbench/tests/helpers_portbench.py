"""Shared pieces of the benchmark's CPU tests: tiny cells (a few lanes) run
on the CPU path, where every kernel runs its plain version."""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = {"sweep": {"batch": 6}}
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@contextlib.contextmanager
def tiny_cells():
    from portbench import catalog

    orig = catalog.traffic

    def traffic(name):
        t = orig(name)
        t.update(TINY[t["kind"]])
        return t

    catalog.traffic = traffic
    try:
        yield catalog.load_benchmark(ROOT)
    finally:
        catalog.traffic = orig
