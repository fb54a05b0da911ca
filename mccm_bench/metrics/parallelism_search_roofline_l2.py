"""Search kernel, in the cell whose network has layer rows past the ones
the kernel stages in shared memory (read from L2): the least time the
traced calls' searches allow over the kernel's profiled time, in %.  The
same reading as ``parallelism_search_roofline``, whose reader it calls."""
from mccm_bench import cells


def read(ctx):
    return cells.reader("parallelism_search_roofline")(ctx)
