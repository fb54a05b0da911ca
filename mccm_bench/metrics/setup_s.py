"""End to end: seconds from the process's start to the end of the
warm-up calls (host clock): imports, the session, the search library's
build or load, the design pool and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
