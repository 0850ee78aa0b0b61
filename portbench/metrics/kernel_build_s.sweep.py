"""Seconds the run's process spent building (nvcc) and loading the
program's kernel libraries (``_build.py``, ``ops/packed_backward.py``): the
program's counters ``build.nvcc_s`` and ``build.load_s``.  A checkout's
first run compiles; later runs only load."""

from portbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "sweep":
        return None
    c = spans.of(ctx)["counters"]
    if not c or "build.nvcc_s" not in c:
        return None
    return c["build.nvcc_s"] + c["build.load_s"]
