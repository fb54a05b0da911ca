"""The readers of the program's spans on the device trace:
``validate_idle_ms`` and ``dispatch_idle_ms`` count only the idle gaps
the trace puts under the program's own spans, per traced call."""
from __future__ import annotations

import pytest

from mccm_bench import cells

SPEC = cells.load_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]
READERS = ("validate_idle_ms", "dispatch_idle_ms")

#: idle seconds by the innermost host event over 5 traced calls: two of
#: the program's spans, its root span, a PyTorch op and a harness span
GAPS = {"session.validate": 0.150, "batch.setup": 0.004,
        "session.evaluate": 0.001, "aten::index": 0.002, "bench.pull": 0.003}


def _ctx(gaps, calls=5):
    return {"profile": {"calls": calls, "idle_gaps": gaps}}


def test_each_reader_counts_only_the_program_spans():
    validate = cells.reader("validate_idle_ms")
    dispatch = cells.reader("dispatch_idle_ms")
    assert validate(_ctx(GAPS)) == pytest.approx(0.150 / 5 * 1e3)
    assert dispatch(_ctx(GAPS)) == pytest.approx((0.004 + 0.001) / 5 * 1e3)
    # a finer span under the program's prefixes keeps the sum
    finer = dict(GAPS, **{"batch.ce_maps": 0.002, "batch.compose": 0.001})
    assert dispatch(_ctx(finer)) == pytest.approx(0.008 / 5 * 1e3)
    assert validate(_ctx(finer)) == validate(_ctx(GAPS))


@pytest.mark.parametrize("name", READERS)
def test_no_profile_reads_nothing(name):
    read = cells.reader(name)
    assert read({"profile": None}) is None
    # a trace without device events has no gaps to name
    assert read({"profile": {"calls": 5, "wall_s": 0.4}}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_nothing(name):
    """A program that puts no span on the trace (the port before its
    spans reached the profiler) leaves the metric out, and does not
    raise."""
    read = cells.reader(name)
    assert read(_ctx({"bench.evaluate": 0.175, "cudaMemcpyAsync": 0.006,
                      "bench.pull": 0.002})) is None


@pytest.mark.parametrize("name", READERS)
def test_both_cells_report_the_reader(name):
    [entry] = [m for m in SPEC["per_layer"] if m["name"] == name]
    assert entry["source"] == "program_span"
    assert entry["layer"] == "host dispatch"
    assert entry["moves"] == "designs_per_s"
    assert entry["workloads"] == CELLS
    for cell in CELLS:
        assert name in [m["name"] for m, _ in
                        cells.readers(SPEC, cell, True)]
