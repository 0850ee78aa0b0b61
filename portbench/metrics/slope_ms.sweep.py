"""Milliseconds of card stream time a traced trip spends in the span
``slope``, the Lagrangian gradient norm, the Armijo slope's recursion over
the horizon and the reg decay (``ops/packed_pipeline.py``). The time
between the span's two CUDA events covers its kernels and any idle while
the card waited for the host to issue them."""

from portbench import spans


def read(ctx):
    return spans.trip_phase_ms(ctx, "slope")
