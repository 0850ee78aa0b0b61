"""``torch.profiler`` read in memory (no trace file is written).

``profile(fn)`` runs ``fn`` under the profiler (host and CUDA activities)
inside a named window and returns the events as plain dicts: ``name``,
``kind`` ("device" for kernels, copies and fills on the card, "host" for
operations on the CPU), ``start`` and ``end`` in microseconds on one clock.
The readers below work on such lists, so they can be held to recorded
events on the CPU.
"""

from __future__ import annotations

import collections

WINDOW = "portbench_window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host operations that wait for the device (``bool``, ``.item()`` and
# ``float`` of a card tensor end in the first)
SYNC_OPS = ("aten::_local_scalar_dense",)


def profile(fn, device) -> list:
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with _profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = kind_of(e)
        if kind is None:
            continue
        start = e.start_ns() / 1e3
        out.append({"name": e.name(), "kind": kind, "start": start,
                    "end": start + e.duration_ns() / 1e3})
    return out


def kind_of(e):
    """"device", "host" or None (neither, such as the device's copy of a
    named range) for one of the profiler's events.  Where the event names
    no activity type (older PyTorch), its device type decides."""
    if hasattr(e, "activity_type"):
        act = e.activity_type()
        return ("device" if act in DEVICE_ACTIVITIES
                else "host" if act in ("cpu_op", "user_annotation", "cuda_runtime",
                                       "cuda_driver") else None)
    if e.device_type().name == "CUDA":
        return None if e.is_user_annotation() or e.name() == WINDOW else "device"
    return "host"


def window(events) -> tuple:
    """(start, end) of the profiled window, microseconds."""
    w = max((e for e in events if e["kind"] == "host" and e["name"] == WINDOW),
            key=lambda e: e["end"] - e["start"])
    return w["start"], w["end"]


def device_ops(events, t0, t1) -> list:
    return [e for e in events if e["kind"] == "device" and e["end"] > t0 and e["start"] < t1]


def busy(events) -> tuple:
    """(busy microseconds, window microseconds, idle gaps as (start, end))
    of the device over the profiled window: the union of its operations."""
    t0, t1 = window(events)
    spans = sorted((max(e["start"], t0), min(e["end"], t1)) for e in device_ops(events, t0, t1))
    total, gaps, cursor = 0.0, [], t0
    for a, b in spans:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            total += b - max(a, cursor)
            cursor = b
    if t1 > cursor:
        gaps.append((cursor, t1))
    return total, t1 - t0, gaps


def kernel_us(events, match) -> tuple:
    """(launches, device microseconds) of the device operations whose name
    ``match`` accepts, inside the window."""
    t0, t1 = window(events)
    hits = [e for e in device_ops(events, t0, t1) if match(e["name"])]
    return len(hits), sum(e["end"] - e["start"] for e in hits)


def host_count(events, names) -> int:
    t0, t1 = window(events)
    return sum(1 for e in events
               if e["kind"] == "host" and e["name"] in names and t0 <= e["start"] < t1)


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the host operation that covers most of each (the
    innermost of equals), in seconds."""
    t0, t1 = window(events)
    by_name = collections.Counter()
    for e in device_ops(events, t0, t1):
        by_name[e["name"]] += e["end"] - e["start"]
    _, _, gaps = busy(events)
    host = [e for e in events if e["kind"] == "host" and e["name"] != WINDOW]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        over = [(min(b, e["end"]) - max(a, e["start"]), e["start"] - e["end"], e["name"])
                for e in host if e["end"] > a and e["start"] < b]
        named.append([max(over)[2] if over else "(no host operation)", (b - a) / 1e6])
    return {"device_ops": [[n, us / 1e6] for n, us in by_name.most_common(top)],
            "idle_gaps": named}
