"""Milliseconds a loop trip of the SL solve (``core/solve_sl.py``): the
window's span over the trips its batches ran (each batch's trips are its
slowest lane's iterations), host clock."""


def read(ctx):
    w = ctx["window"]
    if ctx["traffic"]["kind"] != "sweep" or not w["trips"]:
        return None
    return w["span"] * 1e3 / w["trips"]
