"""The reference, the generator and the yardstick against the program on
the CPU, at a small batch."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mccm_bench import cells, check, reference, traffic, yardstick

SPEC = cells.load_spec()
CONFIGS = {c["name"]: cells.load_config(SPEC, {"config": c["name"]})
           for c in SPEC["configs"]}


def _program(cfg):
    from repro_torch.api import get_board, get_cnn
    return get_cnn(cfg["program"]["cnn"]), get_board(cfg["program"]["board"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configuration_is_the_programs(name):
    """The frozen layer shapes and board are the program's, field for
    field, and the reference's derived sizes agree with its layers'."""
    from mccm_bench.system import check_inputs
    cfg = CONFIGS[name]
    net, board = _program(cfg)
    check_inputs(cfg, net, board)
    for layer, want in zip(cfg["network"]["layers"], net):
        got = reference.layer_sizes(layer)
        assert (got["oh"], got["ow"], got["macs"], got["weights"],
                got["ifm"], got["ofm"]) == (
            want.oh, want.ow, want.macs, want.weights_size, want.ifm_size,
            want.ofm_size)


def test_check_inputs_refuses_another_network():
    from mccm_bench.system import check_inputs
    cfg = CONFIGS["resnet50-zcu102"]
    net, board = _program(CONFIGS["resnet152-zcu102"])
    with pytest.raises(ValueError, match="layers"):
        check_inputs(cfg, net, board)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("family", sorted(traffic.FAMILIES))
def test_reference_equals_the_program(name, family):
    """At 384 designs on the CPU the reference gives the program's metrics
    bit for bit (the same f32 arithmetic in the same order)."""
    from repro_torch.api import Session
    from repro_torch.core.dse.encoding import DesignBatch
    cfg = CONFIGS[name]
    net, board = _program(cfg)
    batch = traffic.FAMILIES[family](traffic.seed_rng(3, 0), len(net), 384)
    got = Session(board, device="cpu").evaluate(
        DesignBatch.from_numpy(*batch), net)
    want = reference.Reference(cfg).evaluate(batch, block=100)
    assert set(got) == set(check.METRICS) == set(want)
    for k in check.METRICS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("family", sorted(traffic.FAMILIES))
def test_generator_draws_the_programs_designs(family):
    """The frozen samplers draw what the program's samplers draw from the
    same generator."""
    from repro_torch.core.dse import samplers
    fn = {"mixed": samplers.sample_mixed}
    mine = traffic.FAMILIES[family](np.random.default_rng(5), 53, 500)
    theirs = fn[family](np.random.default_rng(5), 53, 500).to_numpy()
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)


def test_design_pool_follows_the_seed():
    mix = {"family": "mixed", "designs_per_call": 64, "pool_batches": 2,
           "family_args": {"max_segments": 6}}
    a = traffic.design_pool(mix, 53, 2**31 + 17)
    b = traffic.design_pool(mix, 53, 2**31 + 17)
    c = traffic.design_pool(mix, 53, 2**31 + 18)
    assert all(np.array_equal(x, y) for p, q in zip(a, b)
               for x, y in zip(p, q))
    assert not np.array_equal(a[0][0], c[0][0])
    assert not np.array_equal(a[0][0], a[1][0])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_search_count_is_the_programs_less_the_padding(name):
    """The yardstick's count equals the program's ``ops.search_cost`` on
    the same inputs, less the bytes of the padded layer rows."""
    from repro_torch.api import get_board
    from repro_torch.core.batch_eval import (_ce_maps, _search_ce,
                                             make_tables, search_setup)
    from repro_torch.core.dse.encoding import DesignBatch
    from repro_torch.kernels.mccm_eval.ops import search_cost
    cfg = CONFIGS[name]
    net, _ = _program(cfg)
    arrays = traffic.sample_mixed(traffic.seed_rng(9, 0), len(net), 200)
    t = make_tables(net, device="cpu")
    dev, st = search_setup(t, get_board(cfg["program"]["board"]))
    m = _ce_maps(DesignBatch.from_numpy(*arrays), t, dev)
    ce = _search_ce(m)
    theirs = search_cost(m.pes_ce, ce, *st)
    ref = reference.Reference(cfg)
    _, rm = ref.ce_maps(arrays)
    L, P, K = len(net), st.fc_pair.shape[1], st.cand.numel()
    mine = yardstick.search_count(
        rm["pes_ce"], reference.search_inputs(rm)[:, :L], P, K,
        ref.search_tables["pair_prod"])
    pad = t.max_L - L
    assert mine["flops"] == theirs["flops"]
    assert theirs["bytes"] - mine["bytes"] == 4 * (200 * pad + 2 * pad * P
                                                   + pad)
    assert yardstick.least_seconds(mine) > 0


def test_control_departs_from_the_reference():
    """The reference in bfloat16 put in the program's place reads far
    above the limit on every seed tried (the chip readings are in
    PERF.md)."""
    cfg = CONFIGS["resnet50-zcu102"]
    ref = reference.Reference(cfg)
    control = reference.Reference(cfg, dtype=torch.bfloat16)
    for seed in (1, 2, 3):
        pool = [traffic.sample_mixed(traffic.seed_rng(seed, 0), 53, 256)]
        rows = check.sample_rows(traffic.seed_rng(seed, 1), 256, 64)
        want = check.reference_rows([(0, rows, None)], pool, ref)
        records = check.replay([(0, rows, None)], check.reference_rows(
            [(0, rows, None)], pool, control))
        gap, _ = check.widest_gap(records, want)
        assert gap > 100 * check.LIMITS["max_rel_gap"], (seed, gap)


def test_roofline_reader_reads_the_yardstick():
    """The search's roofline reader counts the traced batches' work by the
    yardstick itself, and finds nothing where no search kernel ran."""
    cfg = CONFIGS["resnet50-zcu102"]
    ref = reference.Reference(cfg)
    pool = [traffic.sample_mixed(traffic.seed_rng(4, 0), 53, 128)]
    _, m = ref.ce_maps(pool[0])
    st = ref.search_tables
    least = yardstick.least_seconds(yardstick.search_count(
        m["pes_ce"], reference.search_inputs(m)[:, :53],
        st["pair_prod"].numel(), st["cand"].numel(), st["pair_prod"]))
    read = cells.reader("parallelism_search_roofline")
    ctx = {"reference": ref, "pool": pool, "trace_order": [0, 0],
           "profile": {"by_kernel": {
               "void parallelism_search_kernel<7>(float const*)":
                   [2, 4 * least],
               "Memcpy HtoD (Pageable -> Device)": [1, 1.0]}}}
    assert read(ctx) == pytest.approx(50.0)
    ctx["profile"] = {"by_kernel": {"Memcpy HtoD": [1, 1.0]}}
    assert read(ctx) is None
