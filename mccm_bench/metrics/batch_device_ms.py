"""Batch path: device milliseconds a call spends in kernels other than
the parallelism search (copies and fills not counted), from the
profiler's trace of the traced calls."""


def read(ctx):
    p = ctx["profile"]
    if p is None or "kernel_s" not in p:
        return None
    search = sum(s for name, (_, s) in p["by_kernel"].items()
                 if "parallelism_search" in name)
    return (p["kernel_s"] - search) / p["calls"] * 1e3
