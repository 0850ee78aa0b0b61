"""Each per-layer metric's reader on a recorded event list, and the trace
readers' arithmetic."""

import pytest

from helpers_portbench import ROOT
from portbench import catalog, harness, peaks, trace

W = trace.WINDOW
K1 = "void riccati_kernel<4, 1, float, SevenArrays<float>, NoMask>(...)"
K3 = "void sl_rollout_kernel<Acrobot, 1, float, Score<1, float> >(...)"
K4 = "void sl_rollout_kernel<Acrobot, 1, float, Reroll<1, float> >(...)"


def ev(name, kind, start, end):
    return {"name": name, "kind": kind, "start": float(start), "end": float(end)}


# a window of 1000 us: two trips, device busy 100-300 and 500-600 us
EVENTS = [
    ev(W, "host", 0, 1000),
    ev("aten::mul", "host", 10, 90), ev("aten::_local_scalar_dense", "host", 310, 320),
    ev("aten::_local_scalar_dense", "host", 650, 660), ev("aten::_local_scalar_dense", "host", 700, 710),
    ev("aten::bmm", "host", 300, 500),
    ev(K1, "device", 100, 150), ev(K3, "device", 150, 200), ev(K4, "device", 200, 300),
    ev(K1, "device", 500, 540), ev(K3, "device", 540, 560), ev(K3, "device", 560, 580),
    ev(K4, "device", 580, 600),
    ev("kernel after the window", "device", 1200, 1300),
]
CONFIG = catalog.config("acrobot_T101")


def context(kind="sweep", answers=None):
    ref = catalog.reference(CONFIG)
    window = {"answers": answers or [], "span": 20.0, "trips": 160,
              "counts": {"riccati": 400, "score": 160, "reroll": 160}}
    shape = harness.shape_of(CONFIG, ref, 4096)
    shape["candidates"] = 17            # a second block on some trips
    return {"config": CONFIG, "traffic": {"kind": kind}, "shape": shape, "window": window,
            "events": EVENTS, "trace_trips": 2}


def test_busy_gaps_and_breakdown():
    busy, span, gaps = trace.busy(EVENTS)
    assert (busy, span) == (300.0, 1000.0)
    assert gaps == [(0.0, 100.0), (300.0, 500.0), (600.0, 1000.0)]
    b = trace.breakdown(EVENTS)
    assert b["device_ops"][0] == [K4, 120e-6]
    assert b["idle_gaps"][0] == ["aten::_local_scalar_dense", 400e-6]
    assert b["idle_gaps"][1] == ["aten::bmm", 200e-6]


def read(name, ctx):
    return catalog.reader(name)(ctx)


def test_sweep_readers():
    ctx = context()
    assert read("trip_ms.sweep", ctx) == pytest.approx(125.0)
    assert read("syncs_per_trip.sweep", ctx) == pytest.approx(1.5)
    assert read("riccati_attempts_per_trip.sweep", ctx) == pytest.approx(2.5)
    assert read("device_idle.sweep", ctx) == pytest.approx(70.0)
    shape = ctx["shape"]
    k1 = 2 * peaks.bound_s(*catalog.kernels()[0].launch(shape))
    assert read("riccati_roofline.sweep", ctx) == pytest.approx(100 * k1 / 90e-6)
    k3, k4 = catalog.kernels()[2], catalog.kernels()[3]
    want = (2 * peaks.bound_s(*k3.launch(shape, 8)) + peaks.bound_s(*k3.launch(shape, 9))
            + 2 * peaks.bound_s(*k4.launch(shape)))
    assert read("rollout_roofline.sweep", ctx) == pytest.approx(100 * want / 210e-6)


def test_sweep_readers_find_nothing_in_another_mix():
    ctx = context("another")
    for m in catalog.load_benchmark(ROOT)["per_layer"]:
        assert read(m["name"], ctx) is None


def test_readers_find_nothing_in_an_empty_trace():
    ctx = context()
    ctx["events"] = [ev(W, "host", 0, 10)]
    assert read("riccati_roofline.sweep", ctx) is None
    assert read("rollout_roofline.sweep", ctx) is None


class _Old:
    """A profiler event of a PyTorch that names no activity type."""

    class _Dev:
        def __init__(self, name):
            self.name = name

    def __init__(self, name, device, annotation=False):
        self._n, self._d, self._a = name, self._Dev(device), annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def test_event_kinds_without_activity_types():
    assert trace.kind_of(_Old(K1, "CUDA")) == "device"
    assert trace.kind_of(_Old(W, "CUDA", annotation=True)) is None
    assert trace.kind_of(_Old("aten::mm", "CPU")) == "host"
    assert trace.kind_of(_Old(W, "CPU", annotation=True)) == "host"
