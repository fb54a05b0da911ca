"""Host dispatch: milliseconds a call the card waits while the program's
host code runs outside validation, from the profiler's trace of the
traced calls: the idle gaps the trace puts under any of the program's
spans (``session.*``, ``batch.*``) other than ``session.validate``, over
the calls.  A span split into finer ones keeps the sum.  None where the
trace holds no gap under any of the program's spans: a program that puts
none on the trace."""


def read(ctx):
    p = ctx["profile"]
    if p is None or "idle_gaps" not in p:
        return None
    ours = {k: v for k, v in p["idle_gaps"].items()
            if k.startswith(("session.", "batch."))}
    if not ours:
        return None
    return sum(v for k, v in ours.items()
               if k != "session.validate") / p["calls"] * 1e3
