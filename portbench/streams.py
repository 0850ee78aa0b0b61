"""The general traffic generator: how a window drives the program.

A traffic mix (``traffic/<mix>.json``) names its ``kind`` and parameters:

* ``sweep``: a closed-loop stream of batches of ``batch`` instances, the
  next batch started when the previous one returns; batch ``i``'s inputs
  drawn from ``(seed, i)`` by the configuration's protocol.

Each stream warms up in ``setup``, runs whole batches in ``window`` until
``seconds`` have passed since its first started, and ``profile``s a few
trips after the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import catalog, inputs, judge, port, trace

WARM_TRIPS = 3          # the warm-up's solve, as chip_smoke.py::run_model
TRACE_SKIP, TRACE_TRIPS = 4, 4


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def record(sol, seed, i, gain_lanes, t0, t1, start):
    """What the window keeps of one answer: the fields the comparison
    reads, the gains only on ``gain_lanes`` lanes drawn from ``(seed, 2,
    i)``, the answer's trips and host times."""
    B = sol.xs.shape[0]
    rng = np.random.default_rng(inputs.seed_of(seed, 2, i))
    lanes = torch.as_tensor(np.sort(rng.choice(B, min(B, gain_lanes), replace=False)),
                            device=sol.xs.device)
    return {"answers": judge.Answers.of(sol, lanes), "start": start, "t0": t0, "t1": t1,
            "trips": int(sol.iterations.max())}


class Sweep:
    def __init__(self, config, traffic, gain_lanes, device, dtype):
        self.config, self.traffic, self.gain_lanes = config, traffic, gain_lanes
        self.device, self.dtype = device, dtype
        self.ref = catalog.reference(config)
        self.B = traffic["batch"]
        self.solver = port.Solver(config, device, dtype)

    def inputs(self, seed, i):
        return inputs.batch(self.config, self.ref, self.B,
                            inputs.generator(self.device, seed, i), self.dtype)

    def setup(self, seed):
        """Warm every shape of this cell: one solve of the first batch's
        inputs cut to a few trips (the kernels' libraries built or loaded,
        the entry's pieces made)."""
        self.solver.capped(WARM_TRIPS)(*self.inputs(seed, 0))
        sync(self.device)

    def window(self, seed, seconds):
        batches, before = [], port.counts()
        t_first = time.perf_counter()
        while not batches or time.perf_counter() - t_first < seconds:
            t0 = time.perf_counter()
            args = self.inputs(seed, len(batches))
            sol = self.solver.solve(*args)
            sync(self.device)
            batches.append(record(sol, seed, len(batches), self.gain_lanes, t0,
                                  time.perf_counter(), args[0][:, 0]))
            del sol
        after = port.counts()
        return {"answers": batches, "span": batches[-1]["t1"] - t_first,
                "trips": sum(b["trips"] for b in batches),
                "counts": {k: after[k] - before[k] for k in after}}

    def profile(self, seed, index):
        """Trips TRACE_SKIP + 1 to TRACE_SKIP + TRACE_TRIPS of a fresh
        batch, traced after untraced ones; (events, trips traced)."""
        gen = self.solver.trips(*self.inputs(seed, index))
        done = 0
        for _ in range(TRACE_SKIP):
            next(gen, None)
        sync(self.device)

        def run():
            nonlocal done
            for _ in range(TRACE_TRIPS):
                if next(gen, StopIteration) is StopIteration:
                    break
                done += 1

        events = trace.profile(run, self.device)
        gen.close()
        return events, done


KINDS = {"sweep": Sweep}


def make(config, traffic, gain_lanes, device, dtype):
    return KINDS[traffic["kind"]](config, traffic, gain_lanes, device, dtype)
