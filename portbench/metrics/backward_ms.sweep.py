"""Milliseconds of card stream time a traced trip spends in the span
``backward``, the backward pass with its regularization retry: the K1/K2
launches and the ``sync.retry`` tests (``ops/packed_pipeline.py``,
``ops/packed_backward.py``). The time between the span's two CUDA events
covers its kernels and any idle while the card waited for the host to issue
them."""

from portbench import spans


def read(ctx):
    return spans.trip_phase_ms(ctx, "backward")
