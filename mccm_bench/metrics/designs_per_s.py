"""End to end: designs evaluated over all of the window's time, from the
first call's start to the last call's end (host clock)."""


def read(ctx):
    return ctx["designs"] / ctx["window_s"]
