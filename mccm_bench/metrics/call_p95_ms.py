"""End to end: the 95th percentile over every call of the window, from
entering ``evaluate`` to the metrics as host arrays (host clock), in ms;
numpy's linear interpolation between the two ranks around it."""
import numpy as np


def read(ctx):
    if not ctx["walls_s"]:
        return None
    return float(np.percentile(np.asarray(ctx["walls_s"], np.float64),
                               95)) * 1e3
