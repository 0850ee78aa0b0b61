"""Share of the SL loop's lane-trips spent on lanes still live
(``core/solve_sl.py``): over the window's batches, the program's solve log
(each finished solve's live lane-trips, the sum of its lanes' iterations)
over lanes x trips.  A stopped lane is frozen by the loop's mask but still
computed every trip, so the rest is work on finished lanes.  None unless
the log's last entries are the window's batches, trip for trip."""

from portbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "sweep":
        return None
    log, answers = spans.of(ctx)["solve_log"], ctx["window"]["answers"]
    if not log or len(log) < len(answers):
        return None
    last = log[len(log) - len(answers):]
    if [e["trips"] for e in last] != [a["trips"] for a in answers]:
        return None
    return 100.0 * sum(e["live_lane_trips"] for e in last) / sum(e["lanes"] * e["trips"]
                                                              for e in last)
