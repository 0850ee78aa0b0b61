"""Profiling: the port's spans and counters, and the trace that shows them.

Counterpart of ``iterativelqr_tpu/utils/profiling.py``:

* ``trace(logdir)`` — ``torch.profiler.profile`` over the host and, where a
  card is visible, its kernels; the trace goes to ``logdir`` as a Chrome /
  Perfetto JSON file (ui.perfetto.dev or chrome://tracing), and the
  profile object is yielded for ``key_averages()`` and ``events()``.
* ``annotate(name)`` — a span around a phase of the program.  It records
  only while a ``torch.profiler`` session records (``trace``, or any other
  profiler the caller runs); otherwise it costs one call and one flag test
  and touches neither the card nor the allocator.  While on, it emits
  ``record_function("ilqr.<name>")`` (and an NVTX range on the card), so
  the profiler's own event list holds it, records a CUDA event on the
  current stream at its start and end where CUDA is in use, and appends a
  record to a bounded list: ``records()`` / ``drain()`` read it.
* ``counters()`` — host counters, always on: kernel launches by family
  (``LaunchCounter``), host syncs by site (``sync(name)``, also a span of
  that name while on) and seconds spent building and loading the kernel
  libraries (``timer(name)``).
* ``solve_log()`` — one entry for each SL solve that finished: its lanes,
  trips and live lane-trips (the lanes the loop still worked on, summed
  over its trips).
* ``timed(fn, *args)`` — steady-state seconds a call.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import time
from typing import Callable, Iterator

import torch

from .checkpoint import tree_leaves

PREFIX = "ilqr."
MAX_RECORDS = 1 << 16
MAX_SOLVES = 1024
SYNC_SITES = ("sync.stop", "sync.retry", "sync.tail")
BUILD_TIMERS = ("build.nvcc_s", "build.load_s")


@contextlib.contextmanager
def trace(logdir: str = "ilqr_profile", **profile_kwargs) -> Iterator[torch.profiler.profile]:
    """Profile the block and write its trace to ``logdir``; extra keyword
    arguments go to ``torch.profiler.profile`` (e.g. ``with_stack=True``
    for the Python frames of each host operation).  Spans record inside."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities, **profile_kwargs) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# --- spans ----------------------------------------------------------------

_ids = itertools.count(1)
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_open: list = []
_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def new_solve() -> int:
    """An id for one solve; its spans carry it, and its top-level spans
    (``init``, each ``trip`` and ``sync.stop``, ``finish``) take it as their
    parent id."""
    return next(_ids)


class _Span:
    __slots__ = ("rec", "rf", "nvtx", "end")

    def __init__(self, name, solve, trip):
        parent = _open[-1] if _open else None
        if parent is not None:
            solve = parent["solve"] if solve is None else solve
            trip = parent["trip"] if trip is None else trip
        self.rec = {"name": name, "id": next(_ids),
                    "parent": parent["id"] if parent is not None else solve,
                    "solve": solve, "trip": trip,
                    "host_start_ns": None, "host_end_ns": None, "events": None}

    def __enter__(self):
        rec = self.rec
        self.rf = torch.profiler.record_function(PREFIX + rec["name"])
        self.rf.__enter__()
        self.nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
        if self.nvtx:
            torch.cuda.nvtx.range_push(PREFIX + rec["name"])
            start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            start.record()
            rec["events"] = (start, self.end)
        rec["host_start_ns"] = time.time_ns()
        _open.append(rec)
        _records.append(rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec["host_end_ns"] = time.time_ns()
        if self.nvtx:
            self.end.record()
            torch.cuda.nvtx.range_pop()
        _open.pop()
        self.rf.__exit__(*exc)
        return False


def annotate(name: str, *, solve: int = None, trip: int = None):
    """A span around the block: shows in traces as ``ilqr.<name>`` (an NVTX
    range on the card) and is recorded, while a profiler records; does
    nothing otherwise.  ``solve`` and ``trip`` default to the enclosing
    span's."""
    if not _recording():
        return _OFF
    return _Span(name, solve, trip)


def records() -> list:
    """The recorded spans, oldest first: ``name``, ``id``, ``parent`` (the
    enclosing span's id, or the solve's), ``solve``, ``trip``,
    ``host_start_ns``, ``host_end_ns`` (Unix-epoch ns, the profiler's clock)
    and ``device_ms``, the stream time between the span's two CUDA events
    (None off the card).  Reads the events: call after the card is synced."""
    out = []
    for rec in _records:
        ev = rec["events"]
        r = {k: v for k, v in rec.items() if k != "events"}
        closed = ev is not None and rec["host_end_ns"] is not None
        r["device_ms"] = ev[0].elapsed_time(ev[1]) if closed else None
        out.append(r)
    return out


def drain() -> list:
    """``records()``, and the list emptied."""
    out = records()
    _records.clear()
    return out


# --- counters -------------------------------------------------------------

_launches: dict = {}
_tally: collections.Counter = collections.Counter(
    {**dict.fromkeys(SYNC_SITES, 0), **dict.fromkeys(BUILD_TIMERS, 0.0)})
_solves: collections.deque = collections.deque(maxlen=MAX_SOLVES)


class LaunchCounter:
    """Counts kernel launches, so a run can show that its main path went
    through the kernel; one with a ``name`` (its kernel family) is listed
    by ``counters()``."""

    def __init__(self, name: str = None):
        self.launches = 0
        if name is not None:
            _launches[name] = self

    def reset(self):
        self.launches = 0


def launch_counters() -> dict:
    """Every named ``LaunchCounter`` by its kernel family."""
    return dict(_launches)


def counters() -> dict:
    """Every counter's value by name: launches by kernel family, host syncs
    by site (``sync.*``), build and load seconds (``build.*``)."""
    out = {name: c.launches for name, c in _launches.items()}
    out.update(_tally)
    return out


def sync(site: str, *, solve: int = None, trip: int = None):
    """Count one host sync at ``site`` (one of ``SYNC_SITES``); the
    returned context is the span of the same name."""
    _tally[site] += 1
    return annotate(site, solve=solve, trip=trip)


@contextlib.contextmanager
def timer(name: str):
    """Add the block's seconds to the counter ``name`` (``BUILD_TIMERS``)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _tally[name] += time.perf_counter() - t0


def log_solve(solve: int, lanes: int, trips: int, live_lane_trips: torch.Tensor):
    """One entry of the solve log; ``live_lane_trips`` stays on its device
    until the log is read."""
    _solves.append({"solve": solve, "lanes": lanes, "trips": trips,
                    "live_lane_trips": live_lane_trips})


def solve_log() -> list:
    """The last ``MAX_SOLVES`` finished solves, oldest first: ``solve``,
    ``lanes``, ``trips`` and ``live_lane_trips`` (reading it waits for the
    card)."""
    return [dict(e, live_lane_trips=int(e["live_lane_trips"])) for e in _solves]


# --- timing ---------------------------------------------------------------

def _wait(out):
    """Wait for the card where ``out`` holds CUDA tensors."""
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in tree_leaves(out)):
        torch.cuda.synchronize()


def timed(fn: Callable, *args, reps: int = 10, warmup: int = 2) -> float:
    """Steady-state wall-clock seconds a call of ``fn(*args)`` (waits for
    the card's outputs)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _wait(out)
    return (time.perf_counter() - t0) / reps
