"""Milliseconds of card stream time a traced trip spends in the span
``line_search``, the line search: K3's head block, ``sync.tail``, the tail
block where needed, the winner's pick, K4 (``ops/sl_ops.py``,
``ops/sl_forward_kernel.py``). The time between the span's two CUDA events
covers its kernels and any idle while the card waited for the host to issue
them."""

from portbench import spans


def read(ctx):
    return spans.trip_phase_ms(ctx, "line_search")
