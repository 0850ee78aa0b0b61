"""The readers of the program's spans, counters and solve log
(``portbench/spans.py`` and its metrics) on recorded records, and the live
lane share of a tiny CPU run against the same batches solved again."""

import time

import pytest
import torch

from helpers_portbench import tiny_cells
from portbench import catalog, harness, inputs, spans, streams, trace

W = trace.WINDOW
NS = 1000          # ns a microsecond: records keep ns, events microseconds
PHASE_MS = {"derive": 30.0, "augment": 5.0, "backward": 2.0, "slope": 4.0,
            "line_search": 8.0, "al_update": 3.0}


def ev(name, kind, start, end):
    return {"name": name, "kind": kind, "start": float(start), "end": float(end)}


def rec(name, id_, parent, start, end, device_ms, trip=None):
    return {"name": name, "id": id_, "parent": parent, "solve": 1, "trip": trip,
            "host_start_ns": start * NS, "host_end_ns": end * NS, "device_ms": device_ms}


def trip_records(first_id, trip, t0):
    """A trip at t0 (microseconds): its sync.stop, the trip span and its six
    phases, each phase at PHASE_MS[phase] + trip of stream time."""
    out = [rec("sync.stop", first_id, 1, t0, t0 + 5, 0.01, trip),
           rec("trip", first_id + 1, 1, t0 + 10, t0 + 400, 60.0, trip)]
    for i, (name, ms) in enumerate(PHASE_MS.items()):
        out.append(rec(name, first_id + 2 + i, first_id + 1, t0 + 10 + 60 * i,
                       t0 + 70 + 60 * i, ms + trip, trip))
    return out


# a window of 1000 us holding two traced trips; a trip before the window
# and a finish with its own derive after the trips
RECORDS = (trip_records(100, 3, -600) + trip_records(200, 4, 50) + trip_records(300, 5, 500)
           + [rec("finish", 400, 1, 920, 990, 9.0), rec("derive", 401, 400, 925, 960, 7.0)])
EVENTS = [ev(W, "host", 0, 1000), ev("ilqr.trip", "host", 60, 450),
          ev("ilqr.derive", "host", 60, 120), ev("ilqr.line_search", "host", 300, 360),
          ev("aten::mul", "host", 305, 310),
          ev("K1", "device", 0, 100), ev("K3", "device", 110, 300), ev("K4", "device", 400, 1000)]


def context(records=RECORDS, counters=None, log=None, answers=(), kind="sweep", trips=2):
    return {"traffic": {"kind": kind}, "events": EVENTS, "trace_trips": trips,
            "window": {"answers": [{"trips": t} for t in answers]},
            "spans": {"records": records, "counters": counters, "solve_log": log}}


def read(name, ctx):
    return catalog.reader(name)(ctx)


@pytest.mark.parametrize("phase", list(PHASE_MS))
def test_phase_readers_sum_the_traced_trips(phase):
    # trips 4 and 5 lie in the window; trip 3 and finish's derive do not count
    want = (2 * PHASE_MS[phase] + 4 + 5) / 2
    assert read(f"{phase}_ms.sweep", context()) == pytest.approx(want)


def test_phase_readers_find_nothing_without_their_data():
    cpu = [dict(r, device_ms=None) for r in RECORDS]
    for phase in PHASE_MS:
        name = f"{phase}_ms.sweep"
        assert read(name, context(records=cpu)) is None            # no events
        assert read(name, context(records=None)) is None           # no recorder
        assert read(name, context(records=[])) is None
        assert read(name, context(trips=3)) is None                # not the traced trips
        assert read(name, context(kind="another")) is None


def test_live_lane_share_reads_the_windows_solves():
    log = [{"solve": 1, "lanes": 8, "trips": 3, "live_lane_trips": 24},      # the warm-up
           {"solve": 5, "lanes": 8, "trips": 10, "live_lane_trips": 50},
           {"solve": 9, "lanes": 8, "trips": 20, "live_lane_trips": 70}]
    assert read("live_lane_share.sweep", context(log=log, answers=[10, 20])) == pytest.approx(
        100.0 * 120 / 240)
    assert read("live_lane_share.sweep", context(log=log, answers=[20, 10])) is None
    assert read("live_lane_share.sweep", context(log=log, answers=[3, 10, 20, 20])) is None
    assert read("live_lane_share.sweep", context(log=None, answers=[10, 20])) is None
    assert read("live_lane_share.sweep", context(log=log, answers=[10, 20],
                                                 kind="another")) is None


def test_kernel_build_seconds_add_build_and_load():
    c = {"build.nvcc_s": 12.5, "build.load_s": 0.25, "sync.stop": 9}
    assert read("kernel_build_s.sweep", context(counters=c)) == pytest.approx(12.75)
    assert read("kernel_build_s.sweep", context(counters={"sync.stop": 9})) is None
    assert read("kernel_build_s.sweep", context(counters=None)) is None
    assert read("kernel_build_s.sweep", context(counters=c, kind="another")) is None


def test_idle_by_span_names_each_gap_by_its_innermost_span():
    # gaps: 100-110 (mid 105: trip, derive ends at 120 -> derive), 300-400
    # (mid 350: line_search inside trip), none after 1000
    assert spans.idle_by_span(EVENTS) == [["ilqr.line_search", 100e-6],
                                          ["ilqr.derive", 10e-6]]
    no_spans = [e for e in EVENTS if not e["name"].startswith("ilqr.")]
    assert spans.idle_by_span(no_spans) == [["(no span)", 110e-6]]


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    from iterativelqr_tpu_torch.utils import profiling

    for name in ("drain", "counters", "solve_log"):
        monkeypatch.delattr(profiling, name)
    ctx = {"traffic": {"kind": "sweep"}}
    assert spans.of(ctx) == {"records": None, "counters": None, "solve_log": None}
    assert spans.of(ctx) is ctx["spans"]


def test_live_lane_share_of_a_tiny_cpu_run():
    """The tiny run's share equals the one worked out from the iterations
    of the same batches solved again from the same seeds; the phase
    readers find no events on the CPU."""
    seed, w = 2 ** 31 + 91, "car.sweep"
    with tiny_cells() as bench:
        result, info = harness.run(bench, w, seed, 0.5, True, "cpu", time.perf_counter())
        cell = catalog.cell(bench, w)
        config = catalog.config(cell["config"])
        stream = streams.make(config, catalog.traffic(cell["traffic"]),
                              catalog.checks(w)["gain_lanes"], torch.device("cpu"),
                              inputs.DTYPES[config["dtype"]])
    live = lanes = 0
    for i in range(info["answers"]):
        its = stream.solver.solve(*stream.inputs(seed, i)).iterations
        live += int(its.sum())
        lanes += its.numel() * int(its.max())
    got = result["metrics"]["live_lane_share.sweep"]["value"]
    assert got == pytest.approx(100.0 * live / lanes, abs=1e-12, rel=0)
    assert 0.0 < got <= 100.0
    for phase in PHASE_MS:
        assert f"{phase}_ms.sweep" not in result["metrics"]
    assert result["metrics"]["kernel_build_s.sweep"]["value"] == 0.0   # nothing built
