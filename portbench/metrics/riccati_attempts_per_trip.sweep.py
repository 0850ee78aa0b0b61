"""Riccati launches a loop trip (backward with its regularization retry,
``ops/packed_pipeline.py``, ``ops/packed_backward.py``): the program's
launch counters of the recursion (K1, K2 and the tall template) over the
window, over the window's trips.  Each batch's exit adds one launch (the
gains about the returned trajectory)."""


def read(ctx):
    w = ctx["window"]
    if ctx["traffic"]["kind"] != "sweep" or not w["trips"] or not w["counts"]["riccati"]:
        return None
    return w["counts"]["riccati"] / w["trips"]
