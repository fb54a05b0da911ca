"""Search kernel: the least time the traced calls' searches allow over
the kernel's profiled time, in %.  The least time is the yardstick's
count of their operations and bytes, at the network's own layer count,
against the H100's f32 rate and HBM bandwidth; the reference works out
each traced batch's CE maps and the search's tables again."""
from mccm_bench import yardstick
from mccm_bench.reference import search_inputs


def read(ctx):
    p = ctx["profile"]
    if p is None or "by_kernel" not in p:
        return None
    kernel_s = sum(s for name, (_, s) in p["by_kernel"].items()
                   if "parallelism_search" in name)
    if kernel_s <= 0:
        return None
    ref = ctx["reference"]
    L = ref.tables["L"]
    st = ref.search_tables
    least = {}
    for k in set(ctx["trace_order"]):
        _, m = ref.ce_maps(ctx["pool"][k])
        least[k] = yardstick.least_seconds(yardstick.search_count(
            m["pes_ce"], search_inputs(m)[:, :L], st["pair_prod"].numel(),
            st["cand"].numel(), st["pair_prod"]))
    return sum(least[k] for k in ctx["trace_order"]) / kernel_s * 100
