"""Host syncs a loop trip on the SL route: the host operations that wait
for the card (``trace.SYNC_OPS``: every ``bool``, ``float`` or ``.item()``
of a card tensor, such as the loop's ``all(stop)``, the regularization
retry's ``ok.all()`` and the line search's tail gate) in the traced trips,
over those trips."""

from portbench import trace


def read(ctx):
    if ctx["traffic"]["kind"] != "sweep" or not ctx["trace_trips"]:
        return None
    return trace.host_count(ctx["events"], trace.SYNC_OPS) / ctx["trace_trips"]
