"""The program's spans, counters and solve log, as the benchmark reads them
(``iterativelqr_tpu_torch/utils/profiling.py``; read-only).

``of(ctx)`` reads the recorder once per run, after the traced sub-window
(its spans, whose CUDA events that window's last sync has completed) and
the window (its solve log), and keeps what it read in the readers'
context, so every reader of the run sees the same records.  A program
without a part of the recorder gives None for that part.

``idle_by_span(events)`` names each idle gap of a traced window by the
innermost span over its middle; no metric reads it.
"""

from __future__ import annotations

import collections

from portbench import trace

PREFIX = "ilqr."        # the profiler's name of a span is PREFIX + its name
PHASES = ("derive", "augment", "backward", "slope", "line_search", "al_update")


def read_program() -> dict:
    """``records`` (emptied after the read), ``counters`` and
    ``solve_log`` of the program's recorder, each None where it has none."""
    try:
        from iterativelqr_tpu_torch.utils import profiling
    except ImportError:
        return dict.fromkeys(("records", "counters", "solve_log"))
    part = lambda name: getattr(profiling, name)() if hasattr(profiling, name) else None
    return {"records": part("drain"), "counters": part("counters"),
            "solve_log": part("solve_log")}


def of(ctx) -> dict:
    """The recorder's parts for this run, read at the first call."""
    if "spans" not in ctx:
        ctx["spans"] = read_program()
    return ctx["spans"]


def trip_phase_ms(ctx, phase: str):
    """Stream milliseconds a traced trip of the spans named ``phase`` whose
    parent is a ``trip`` span of the traced window: the time between each
    span's two CUDA events, summed over the window, over its trips.  None
    where a span has no events (the CPU) or the trips are not the traced
    ones."""
    if ctx["traffic"]["kind"] != "sweep" or not ctx["trace_trips"]:
        return None
    recs = of(ctx)["records"]
    if not recs:
        return None
    t0, t1 = trace.window(ctx["events"])
    inside = [r for r in recs if r["host_end_ns"] is not None
              and r["host_start_ns"] / 1e3 < t1 and r["host_end_ns"] / 1e3 > t0]
    trips = {r["id"] for r in inside if r["name"] == "trip"}
    if len(trips) != ctx["trace_trips"]:
        return None
    ms = [r["device_ms"] for r in inside if r["name"] == phase and r["parent"] in trips]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(trips)


def idle_by_span(events) -> list:
    """Idle seconds of the device over the traced window by the innermost
    span (``ilqr.*`` host range) over each gap's middle, most first;
    "(no span)" where none is."""
    _, _, gaps = trace.busy(events)
    spans = [e for e in events if e["kind"] == "host" and e["name"].startswith(PREFIX)]
    idle = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        over = [e for e in spans if e["start"] <= mid < e["end"]]
        name = min(over, key=lambda e: e["end"] - e["start"])["name"] if over else "(no span)"
        idle[name] += (b - a) / 1e6
    return [[name, s] for name, s in idle.most_common()]
