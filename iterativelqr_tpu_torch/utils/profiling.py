"""Profiling helpers.

Counterpart of ``iterativelqr_tpu/utils/profiling.py``:

* ``trace(logdir)`` — ``torch.profiler.profile`` over the host and, where a
  card is visible, its kernels; the trace goes to ``logdir`` as a Chrome /
  Perfetto JSON file (ui.perfetto.dev or chrome://tracing), and the
  profile object is yielded for ``key_averages()`` and ``events()``.
* ``annotate(name)`` — a named range: ``torch.profiler.record_function``,
  plus an NVTX range on the card.
* ``timed(fn, *args)`` — steady-state seconds a call.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch

from .checkpoint import tree_leaves


@contextlib.contextmanager
def trace(logdir: str = "ilqr_profile", **profile_kwargs) -> Iterator[torch.profiler.profile]:
    """Profile the block and write its trace to ``logdir``; extra keyword
    arguments go to ``torch.profiler.profile`` (e.g. ``with_stack=True``
    for the Python frames of each host operation)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities, **profile_kwargs) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range around the block (shows in traces and, on the card,
    as an NVTX range)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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
