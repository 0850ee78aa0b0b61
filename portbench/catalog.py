"""Finding what a run needs by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics; the
rest lives in files named after its entries:

* ``configs/<config>.json``: a configuration (problem, horizon, dtype,
  options, input protocol, guarantees); its plain reference is
  ``reference/<model>.py`` beside the frozen NumPy oracle;
* ``traffic/<mix>.json``: a traffic mix, read by ``streams.py``;
* ``cells/<workload>.json``: a cell's comparison (samples and limits);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``;
* ``kernels/<kernel>.py``: a kernel's operations and bytes.

A later change adds a cell, configuration, mix, metric or kernel by adding
files and entries; none of these modules needs an edit for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def checks(workload: str) -> dict:
    return _json("cells", workload)


def reference(config: dict):
    """The configuration's plain reference problem."""
    return importlib.import_module(f"portbench.reference.{config['model']}").make(config)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """``read(ctx) -> value or None`` of a per-layer metric."""
    return _module(HERE / "metrics" / f"{metric}.py").read


def kernels() -> list:
    """Every kernel bound module, in name order."""
    return [_module(p) for p in sorted((HERE / "kernels").glob("*.py"))]


def metrics_of(bench: dict, section: str, workload: str) -> list:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    workload reports."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]
