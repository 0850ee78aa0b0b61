"""Share of the traced trips in which no operation ran on the card."""

from portbench import trace


def read(ctx):
    if ctx["traffic"]["kind"] != "sweep":
        return None
    busy, span, _ = trace.busy(ctx["events"])
    return 100.0 * (1.0 - busy / span)
