"""The system under test, as the benchmark reaches it.

The only module of the benchmark that imports the program
(``iterativelqr_tpu_torch``): the problem of a configuration, its options,
the user entry ``parallel.make_batched_solve_fn``, the SL route's pieces for
stepping trip by trip in a traced sub-window, and the program's launch
counters.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from iterativelqr_tpu_torch import Options, build_spec
from iterativelqr_tpu_torch.core import solve_sl
from iterativelqr_tpu_torch.ops import packed_backward as pk
from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk
from iterativelqr_tpu_torch.parallel import make_batched_solve_fn

# the program's launch counters by the kernel they count
COUNTERS = {
    "riccati": (pk.RICCATI_LAUNCHES, pk.RICCATI_WIDE_LAUNCHES, pk.RICCATI_TALL_LAUNCHES),
    "score": (fk.SCORE_LAUNCHES, fk.GENERATED_SCORE_LAUNCHES),
    "reroll": (fk.REROLL_LAUNCHES, fk.GENERATED_REROLL_LAUNCHES),
}


def counts() -> dict:
    """Launches so far of each counted kernel family."""
    return {k: sum(c.launches for c in cs) for k, cs in COUNTERS.items()}


def spec_of(config: dict):
    """The configuration's problem from the program's model library."""
    model = importlib.import_module(f"iterativelqr_tpu_torch.models.{config['model']}")
    return build_spec(*model.problem(config["T"], **config.get("problem", {}))[:3])


def options_of(config: dict) -> Options:
    return Options(**config["options"])


class Solver:
    """One configuration's solvers on one device: the user entry, the same
    options capped at a few trips for the warm-up, and the SL route's
    pieces for tracing."""

    def __init__(self, config: dict, device, dtype):
        self.spec = spec_of(config)
        self.options = options_of(config)
        self.device, self.dtype = torch.device(device), dtype
        kw = dict(device=self.device, dtype=dtype)
        self.solve = make_batched_solve_fn(self.spec, self.options, **kw)
        self._kw = kw

    def capped(self, trips: int):
        """The entry with the configuration's options cut to ``trips``
        loop trips (the warm-up's solve)."""
        return make_batched_solve_fn(
            self.spec, dataclasses.replace(self.options, max_total_iterations=trips),
            **self._kw)

    def trips(self, *args):
        """The entry's SL solve as a generator that yields after queueing
        each loop trip (``core/solve_sl.py::sl_trips``)."""
        parts = solve_sl.make_sl_parts(self.spec, self.options, **self._kw)
        return solve_sl.sl_trips(parts, *args)
