"""Host dispatch: the median milliseconds a call spends inside
``Session.evaluate`` before it returns (the pull follows), host clock,
over the window's calls."""
import statistics


def read(ctx):
    if not ctx["enqueue_s"]:
        return None
    return statistics.median(ctx["enqueue_s"]) * 1e3
