"""The DenseNet-264 configuration and the generation mix on the CPU: the
configuration is refused another DenseNet's layers, the reference pads it
to its 288 rows, the generation cell is what its mix says, and the
search's roofline in the cell past the staged rows reads what the
search's own reader reads."""
from __future__ import annotations

import pytest

from mccm_bench import cells, reference, traffic

SPEC = cells.load_spec()
DEEP = cells.load_config(SPEC, {"config": "densenet264-zcu102"})


def test_check_inputs_refuses_densenet121_against_densenet264():
    from repro_torch.api import get_board, get_cnn
    from mccm_bench.system import check_inputs
    with pytest.raises(ValueError, match="layers"):
        check_inputs(DEEP, get_cnn("densenet121"), get_board("zcu102"))


def test_reference_pads_densenet264_to_288_rows():
    ref = reference.Reference(DEEP)
    assert ref.tables["L"] == 264 == len(DEEP["network"]["layers"])
    assert DEEP["model"]["layer_rows"] == 288
    assert ref.search_tables["pair_prod"].numel() == 219
    assert DEEP["program"] == {"cnn": "densenet264", "board": "zcu102"}


def test_generation_mix_is_one_search_generation():
    """4,096 designs a call at the session's default chunk (no ``chunk``
    in the mix), so two blocks and two search launches a call."""
    from repro_torch.core.batch_eval import DEFAULT_CHUNK
    from repro_torch.core.dse.search import SearchConfig
    mix = cells.load_mix("generation")
    assert mix["designs_per_call"] == SearchConfig().pop_size == 4096
    assert "chunk" not in mix["session"] and mix["session"]["mesh"] == 1
    assert mix["designs_per_call"] // DEFAULT_CHUNK == 2
    cell = cells.find_cell(SPEC, "resnet50-zcu102.generation")
    assert cell["traffic"] == "generation" and cell["chips"] == 1
    pool = traffic.design_pool(dict(mix, pool_batches=1), 53, 2**31 + 5)
    assert pool[0][0].shape == (4096, traffic.NS)


def test_roofline_past_the_staged_rows_is_the_searchs_reading():
    """The new per-layer metric calls the search's roofline reader, and
    is listed only for the cell whose rows pass the staged ones."""
    ref = reference.Reference(DEEP)
    pool = [traffic.sample_mixed(traffic.seed_rng(6, 0), 264, 64)]
    ctx = {"reference": ref, "pool": pool, "trace_order": [0],
           "profile": {"by_kernel": {
               "void parallelism_search_kernel<7>(float const*)":
                   [1, 1e-3]}}}
    read = cells.reader("parallelism_search_roofline_l2")
    assert read(ctx) == cells.reader("parallelism_search_roofline")(ctx) > 0
    ctx["profile"] = None
    assert read(ctx) is None
    [m] = [m for m in SPEC["per_layer"]
           if m["name"] == "parallelism_search_roofline_l2"]
    assert m["workloads"] == ["densenet264-zcu102.bulk"]
