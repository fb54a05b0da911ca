"""The port's scalar Builder (``repro_torch.core.{blocks, builder,
accelerator, evaluator}``), its front door (``Session.evaluate`` on one
design, ``build``, ``explain``) and the report, against the JAX package's,
on the CPU; and the port's batch path against the port's Builder.

Both Builders are the same Python arithmetic on ints and floats, so every
field, per-segment record, per-layer record and per-CE busy time must be
equal (==).  The batch path runs in f32 and is held to the tolerances the
JAX package holds its own batch path to (``tests/test_batch_eval.py:15``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.api import Session as JaxSession
from repro.cnn.registry import CNN_NAMES
from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core.builder import _largest_remainder as jax_largest_remainder
from repro.core.dse import decode_design as jax_decode_design
from repro.core.dse import sample_mixed as jax_sample_mixed
from repro.core.evaluator import _evaluate_design as jax_evaluate_design
from repro.core.evaluator import build_design as jax_build_design
from repro.fpga.archs import ARCH_NAMES
from repro.fpga.archs import make_arch as jax_make_arch
from repro.fpga.boards import BOARD_NAMES
from repro.fpga.boards import get_board as jax_get_board
from repro.telemetry.report import format_report as jax_format_report
from repro_torch.api import EvalError, Session, format_report, get_board, \
    get_cnn
from repro_torch.core.accelerator import Metrics
from repro_torch.core.blocks import best_parallelism, layer_cycles
from repro_torch.core.builder import _largest_remainder
from repro_torch.core.dse import decode_design, sample_mixed
from repro_torch.core.evaluator import _evaluate_design, build_design
from repro_torch.fpga.archs import make_arch

from torch_golden import GOLDEN, SCALAR_FIELDS, TEMPLATE_NS, scalar_rows

#: ``tests/test_batch_eval.py:15``: f32 batch path vs exact scalar path
RTOL = {"latency_s": 1e-4, "throughput_ips": 1e-4,
        "buffer_bytes": 1e-4, "access_bytes": 0.04}


def _templates(cnn):
    jnet, net = jax_get_cnn(cnn), get_cnn(cnn)
    return (jnet, net,
            [jax_make_arch(a, jnet, n) for a in ARCH_NAMES
             for n in TEMPLATE_NS],
            [make_arch(a, net, n) for a in ARCH_NAMES for n in TEMPLATE_NS])


def _mixed():
    """24 sample_mixed ResNet-50 rows (``tests/test_batch_eval.py:40``),
    decoded by each package, with each row's inter-segment flag."""
    jnet, net = jax_get_cnn("resnet50"), get_cnn("resnet50")
    jdb = jax_sample_mixed(np.random.default_rng(7), len(jnet), 24)
    db = sample_mixed(np.random.default_rng(7), len(net), 24)
    return (jnet, net,
            [jax_decode_design(jdb, i, len(jnet)) for i in range(24)],
            [decode_design(db, i, len(net)) for i in range(24)],
            [bool(x) for x in db.inter_pipe])


def _assert_same(got, want, label):
    """Two dataclass trees (Metrics, ConcreteAccelerator) of the two
    packages: equal field for field, down to every per-layer record."""
    assert type(got).__name__ == type(want).__name__, label
    assert dataclasses.asdict(got) == dataclasses.asdict(want), label


@pytest.mark.parametrize("cnn", CNN_NAMES)
def test_builder_equals_jax_on_templates(cnn):
    """Every template of every CNN on VCU108: the built accelerator and
    every Metrics field, per_segment, blocks[*].per_layer and ce_busy_s."""
    jnet, net, jspecs, specs = _templates(cnn)
    jdev, dev = jax_get_board("vcu108"), get_board("vcu108")
    ses = Session(dev, device="cpu")
    for js, s in zip(jspecs, specs):
        label = f"{cnn}/{s.name}"
        _assert_same(build_design(s, net, dev),
                     jax_build_design(js, jnet, jdev), label)
        got = ses.evaluate(s, net)
        assert isinstance(got, Metrics)
        _assert_same(got, jax_evaluate_design(js, jnet, jdev), label)
        assert got.blocks and got.ce_busy_s


def test_builder_equals_jax_on_mixed_designs():
    """24 sample_mixed ResNet-50 designs on ZC706, each with its row's
    inter-segment pipelining flag."""
    jnet, net, jspecs, specs, inter = _mixed()
    jdev, dev = jax_get_board("zc706"), get_board("zc706")
    ses = Session(dev, device="cpu")
    for i, (js, s, ip) in enumerate(zip(jspecs, specs, inter)):
        want = jax_evaluate_design(js, jnet, jdev,
                                   inter_segment_pipelining=ip)
        got = ses.evaluate(s, net, inter_segment_pipelining=ip)
        _assert_same(got, want, f"mixed {i}")


@pytest.mark.parametrize("seed", range(3))
def test_largest_remainder_and_parallelism_equal_jax(seed):
    from repro.core.blocks import best_parallelism as jax_best_parallelism
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 12))
        shares = [float(x) for x in rng.integers(0, 10 ** 9, n)]
        total = int(rng.integers(1, 3000))
        assert _largest_remainder(shares, total) == \
            jax_largest_remainder(shares, total)
    net, jnet = get_cnn("mobilenetv2"), jax_get_cnn("mobilenetv2")
    for pes in rng.integers(1, 2600, 8):
        lo = int(rng.integers(0, len(net) - 4))
        assert best_parallelism(int(pes), net.layers[lo:lo + 4]) == \
            jax_best_parallelism(int(pes), jnet.layers[lo:lo + 4])


@pytest.mark.parametrize("cnn", CNN_NAMES)
def test_batch_path_meets_port_builder(cnn):
    """The port's batch path (CPU) against the port's own scalar Builder on
    every template, with the JAX package's scalar-vs-batch tolerances."""
    _, net, _, specs = _templates(cnn)
    ses = Session(get_board("vcu108"), device="cpu")
    batch = ses.evaluate(specs, net)
    for i, s in enumerate(specs):
        m = ses.evaluate(s, net)
        want = {"latency_s": m.latency_s, "throughput_ips": m.throughput_ips,
                "buffer_bytes": float(m.buffer_bytes),
                "access_bytes": m.access_bytes}
        for k, tol in RTOL.items():
            np.testing.assert_allclose(float(batch[k][i]), want[k],
                                       rtol=tol, err_msg=f"{s.name} {k}")


def test_batch_path_meets_port_builder_on_mixed_designs():
    _, net, _, specs, inter = _mixed()
    ses = Session(get_board("zc706"), device="cpu")
    batch = ses.evaluate(specs, net)
    for i, (s, ip) in enumerate(zip(specs, inter)):
        m = ses.evaluate(s, net, inter_segment_pipelining=ip)
        want = {"latency_s": m.latency_s, "throughput_ips": m.throughput_ips,
                "buffer_bytes": float(m.buffer_bytes),
                "access_bytes": m.access_bytes}
        for k, tol in RTOL.items():
            np.testing.assert_allclose(float(batch[k][i]), want[k],
                                       rtol=tol, err_msg=f"mixed {i} {k}")


def test_explain_equals_jax():
    """``Session.explain`` returns the JAX package's report dict, and
    ``format_report`` renders it the same."""
    jnet, net = jax_get_cnn("resnet50"), get_cnn("resnet50")
    jses = JaxSession(jax_get_board("zcu102"))
    ses = Session(get_board("zcu102"), device="cpu")
    designs = ["{L1-Last:CE1-CE4}", "{L1-L20:CE1, L21-Last:CE2-CE5}"]
    designs += [(jax_make_arch(a, jnet, 5), make_arch(a, net, 5))
                for a in ARCH_NAMES]
    for d in designs:
        jd, pd = d if isinstance(d, tuple) else (d, d)
        want = jses.explain(jd, jnet)
        got = ses.explain(pd, net)
        assert got == want, str(pd)
        assert format_report(got) == jax_format_report(want)
    jses.close()


def test_scalar_path_errors_and_build():
    net = get_cnn("resnet50")
    ses = Session(get_board("zcu102"), device="cpu")
    with pytest.raises(EvalError) as e:
        ses.evaluate("{L1-L9:CE1}", net)             # does not cover layers
    assert e.value.code == EvalError.INVALID_INPUT
    with pytest.raises(EvalError) as e:
        ses.explain(["{L1-Last:CE1}"], net)
    assert e.value.code == EvalError.INVALID_INPUT
    with pytest.raises(EvalError) as e:
        ses.explain("{L1-Last:CE1}", net, refine="bogus")
    assert e.value.code == EvalError.INVALID_INPUT
    rep = ses.explain("{L1-Last:CE1}", net, refine="schedule")
    assert rep["summary"] == ses.explain("{L1-Last:CE1}", net)["summary"]
    sched = rep["schedule"]
    assert sched["latency_s"] <= sched["coarse_latency_s"]
    assert [s["index"] for s in sched["segments"]] == [0]
    acc = ses.build("{L1-L20:CE1, L21-Last:CE2-CE5}", net,
                    inter_segment_pipelining=False)
    assert not acc.spec.inter_segment_pipelining
    m = ses.evaluate("{L1-L20:CE1, L21-Last:CE2-CE5}", net,
                     inter_segment_pipelining=False)
    assert m == _evaluate_design(acc.spec, net, get_board("zcu102"))
    assert ses.stats.scalar_evals == 4         # the refused one counts


def test_layer_cycles_is_eq1():
    """Eq. 1 on every layer of a CNN under a few parallelism vectors, as
    the product of ceil-divisions over the six loop dimensions."""
    from repro.core.blocks import CE as JaxCE
    from repro.core.blocks import layer_cycles as jax_layer_cycles
    from repro_torch.core.blocks import CE
    for par in ({"f": 16, "oh": 4, "ow": 7}, {"f": 3, "ow": 24},
                {"c": 2, "kh": 3, "oh": 5}):
        pes = int(np.prod(list(par.values())))
        for l, jl in zip(get_cnn("xception"), jax_get_cnn("xception")):
            assert layer_cycles(l, CE("p", pes, par)) == \
                jax_layer_cycles(jl, JaxCE("p", pes, par))


def test_golden_scalar_rows_match_port():
    """The port's scalar path meets the golden scalar rows exactly on every
    CNN x board (the check ``chip_smoke.py`` phase 5 makes on the card)."""
    golden = np.load(GOLDEN)
    for cnn in CNN_NAMES:
        _, net, _, specs = _templates(cnn)
        for board in BOARD_NAMES:
            ses = Session(get_board(board), device="cpu")
            got = scalar_rows([ses.evaluate(s, net) for s in specs])
            for k in SCALAR_FIELDS + ("ce_busy_s",):
                np.testing.assert_array_equal(
                    got[k], golden[f"scalar/{cnn}/{board}/{k}"],
                    err_msg=f"{cnn}/{board}/{k}")
