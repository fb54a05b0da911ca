"""Device: the share of a call's wall time in which nothing ran on the
card, in %: 1 - busy time of the traced calls (profiler) over the same
number of calls' median wall without the profiler (host clock)."""
import statistics


def read(ctx):
    p = ctx["profile"]
    if p is None or "busy_s" not in p or not ctx["walls_s"]:
        return None
    wall = p["calls"] * statistics.median(ctx["walls_s"])
    return (1 - p["busy_s"] / wall) * 100
