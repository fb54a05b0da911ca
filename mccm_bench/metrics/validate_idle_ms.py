"""Host dispatch: milliseconds a call the card waits while the program
validates the designs, from the profiler's trace of the traced calls:
the idle gaps the trace puts under the program's ``session.validate``
span, over the calls.  None where the trace holds no gap under any of
the program's spans (``session.*``, ``batch.*``): a program that puts
none on the trace."""


def read(ctx):
    p = ctx["profile"]
    if p is None or "idle_gaps" not in p:
        return None
    gaps = p["idle_gaps"]
    if not any(k.startswith(("session.", "batch.")) for k in gaps):
        return None
    return gaps.get("session.validate", 0.0) / p["calls"] * 1e3
