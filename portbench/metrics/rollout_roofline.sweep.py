"""Share of their roofline the line search's rollout kernels reach (K3 and
K4, ``ops/sl_forward_kernel.py``, ``csrc/sl_rollout.cuh``): the least time
of their launches in the traced trips over their device time.  A trip
scores its first block of min(8, candidates) candidates in one K3 launch,
and the rest in a second launch only when some lane accepted none of the
first; K4 re-rolls once a trip."""

from portbench import catalog, trace
from portbench.peaks import bound_s


def read(ctx):
    if ctx["traffic"]["kind"] != "sweep":
        return None
    shape, size, trips = ctx["shape"], ctx["shape"]["size"], ctx["trace_trips"]
    na = shape["candidates"]
    head = min(8, na)
    bound = spent = 0.0
    for k in catalog.kernels():
        if k.ROLE != "rollout":
            continue
        n, us = trace.kernel_us(ctx["events"], k.match)
        if not n:
            continue
        spent += us / 1e6
        if getattr(k, "SCORES", False):
            heads = min(n, trips)
            bound += heads * bound_s(*k.launch(shape, head), size)
            if n > heads:
                bound += (n - heads) * bound_s(*k.launch(shape, na - head), size)
        else:
            bound += n * bound_s(*k.launch(shape), size)
    return 100.0 * bound / spent if spent else None
