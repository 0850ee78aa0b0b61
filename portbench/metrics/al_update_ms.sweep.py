"""Milliseconds of card stream time a traced trip spends in the span
``al_update``, the AL update: the stopping tests, the violation, the dual
update and the carry (``core/solve_sl.py``). The time between the span's
two CUDA events covers its kernels and any idle while the card waited for
the host to issue them."""

from portbench import spans


def read(ctx):
    return spans.trip_phase_ms(ctx, "al_update")
