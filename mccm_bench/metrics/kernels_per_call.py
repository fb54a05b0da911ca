"""Batch path: kernels a call launches on the device (copies and fills
not counted), from the profiler's trace of the traced calls."""


def read(ctx):
    p = ctx["profile"]
    if p is None or "kernels" not in p:
        return None
    return p["kernels"] / p["calls"]
