"""The port's front door (``repro_torch.api.Session``), samplers and
encoding against the JAX package's, on the CPU; the port's import
isolation; and the golden file ``chip_smoke.py`` checks the card against.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core import batch_eval as jbe
from repro.core.dse import encoding as jenc
from repro.core.dse import samplers as jsamplers
from repro.fpga.archs import ARCH_NAMES, make_arch
from repro.fpga.boards import get_board as jax_get_board
from repro_torch.api import EvalConfig, EvalError, Session, get_board, \
    get_cnn
from repro_torch.core.dse import encoding as tenc
from repro_torch.core.dse import samplers as tsamplers
from repro_torch.fpga.archs import make_arch as port_make_arch

from torch_golden import GOLDEN, compute_golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _np(out):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _assert_metrics(got, want, label):
    for k, w in want.items():
        w = np.asarray(w)
        if k == "n_ces":
            np.testing.assert_array_equal(got[k], w, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                       err_msg=f"{label} {k}")


def _no_host_route(*args, **kwargs):
    raise AssertionError("the DesignBatch went through the host")


@pytest.mark.parametrize("family,seed", [("mixed", 0), ("mixed", 7),
                                         ("custom", 0), ("custom", 3)])
def test_samplers_equal_jax(family, seed):
    for n_layers in (1, 2, 53, 155):
        want = getattr(jsamplers, f"sample_{family}")(
            np.random.default_rng(seed), n_layers, 300)
        got = getattr(tsamplers, f"sample_{family}")(
            np.random.default_rng(seed), n_layers, 300)
        for g, w in zip(got.to_numpy(), want.to_numpy()):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_encode_decode_validate_equal_jax():
    net = jax_get_cnn("xception")
    specs = [make_arch(a, net, n) for a in ARCH_NAMES for n in (2, 5, 9)]
    got, want = tenc.encode_specs(specs, len(net)), \
        jenc.encode_specs(specs, len(net))
    for g, w in zip(got.to_numpy(), want.to_numpy()):
        np.testing.assert_array_equal(g, w)
    # the two packages' spec classes are distinct; their fields match
    assert [repr(d) for d in tenc.decode_batch(got, len(net))] == \
        [repr(d) for d in jenc.decode_batch(want, len(net))]
    bad = [np.array(a) for a in want.to_numpy()]
    bad[2][0, 0] = 40                               # 40 CEs: too many
    bad[0][1, 3] = 2                                # not nondecreasing
    np.testing.assert_array_equal(
        tenc.validate_batch(tenc.DesignBatch.from_numpy(*bad), len(net)),
        jenc.validate_batch(jenc.DesignBatch.from_numpy(*bad), len(net)))


def test_session_evaluate_matches_jax(monkeypatch):
    """Session(device="cpu") on a spec list, on notation strings and on a
    DesignBatch against the JAX package's batch path.  The DesignBatch is
    checked as tensors on the session's device: never read back to the
    host and never through the numpy ``validate_batch``."""
    jnet, net = jax_get_cnn("densenet121"), get_cnn("densenet121")
    specs = [make_arch(a, jnet, n) for a in ARCH_NAMES for n in (2, 5, 11)]
    mixed = jsamplers.sample_mixed(np.random.default_rng(4), len(jnet), 40)
    ses = Session(get_board("vcu108"), device="cpu")
    port_specs = [port_make_arch(a, net, n) for a in ARCH_NAMES
                  for n in (2, 5, 11)]
    want_t = jbe.evaluate_batch(jbe.encode_specs(specs, len(jnet)),
                                jbe.make_tables(jnet),
                                jax_get_board("vcu108"), backend="ref")
    _assert_metrics(ses.evaluate(port_specs, net), want_t, "specs")
    strings = ["{L1-Last:CE1-CE4}", "{L1:CE1, L2:CE2, L3-Last:CE3}"]
    from repro.core.notation import parse
    want_s = jbe.evaluate_batch(
        jbe.encode_specs([parse(s, len(jnet)) for s in strings], len(jnet)),
        jbe.make_tables(jnet), jax_get_board("vcu108"), backend="ref")
    _assert_metrics(ses.evaluate(strings, net), want_s, "strings")
    want_m = jbe.evaluate_batch(mixed, jbe.make_tables(jnet),
                                jax_get_board("vcu108"), backend="ref")
    port_mixed = tenc.DesignBatch.from_numpy(*mixed.to_numpy())
    monkeypatch.setattr(tenc, "validate_batch", _no_host_route)
    monkeypatch.setattr(tenc.DesignBatch, "to_numpy", _no_host_route)
    got_m = ses.evaluate(port_mixed, net)
    assert all(v.device.type == "cpu" for v in got_m.values())
    _assert_metrics(_np(got_m), want_m, "design_batch")
    assert ses.stats.net_table_builds == 1
    assert ses.stats.net_table_hits == 2
    assert ses.stats.device_table_builds == 1


def test_session_memo_is_bounded_lru():
    ses = Session(get_board("zc706"), device="cpu", max_cached_tables=1)
    a, b = get_cnn("vgg16"), get_cnn("mobilenetv2")
    ta = ses.tables(a)
    assert ses.tables(a) is ta
    ses.tables(b)
    assert ses.tables(a) is not ta                  # evicted and rebuilt
    assert ses.stats.net_table_evictions == 2
    assert ses.stats.net_table_builds == 3


def test_session_without_card_raises(monkeypatch):
    """The default device is cuda; with no card visible the Session
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a visible CUDA card"):
        Session(get_board("zc706"))
    with pytest.raises(RuntimeError, match="needs a visible CUDA card"):
        Session(config=EvalConfig(device="cuda:0"))
    assert Session(device="cpu").device.type == "cpu"


def test_session_errors():
    net = get_cnn("resnet50")
    ses = Session(get_board("zcu102"), device="cpu")
    # one design runs the scalar Builder: a Metrics, and its errors are
    # EvalErrors too
    m = ses.evaluate("{L1-Last:CE1-CE4}", net)
    assert m.latency_s > 0 and len(m.per_segment) == 1
    with pytest.raises(EvalError) as e:
        ses.evaluate("{L1-L9:CE1}", net)
    assert e.value.code == EvalError.INVALID_INPUT
    with pytest.raises(EvalError) as e:
        ses.evaluate(["{L1-L9:CE1}"], net)          # does not cover layers
    assert e.value.code == EvalError.INVALID_INPUT
    with pytest.raises(EvalError) as e:
        ses.evaluate([], net)
    assert e.value.code == EvalError.INVALID_INPUT
    db = tsamplers.sample_mixed(np.random.default_rng(0), len(net), 4)
    db.seg_nce[1, 0] = 40
    with pytest.raises(EvalError) as e:
        ses.evaluate(db, net)
    assert e.value.code == EvalError.INVALID_INPUT
    assert "first at index 1" in str(e.value)
    with pytest.raises(ValueError, match="chunk"):
        Session(device="cpu", chunk=0)


#: VGG-16 has 13 conv layers, one more segment than NS = 12 allows
_SEGMENTS_13 = "{" + ", ".join(f"L{i}:CE{i}" for i in range(1, 13)) \
    + ", L13-Last:CE13}"


def _fault(*args, **kwargs):
    raise RuntimeError("conv_ce kernel launch failed: CUDA error 700")


def _eval_error(*args, **kwargs):
    raise EvalError(EvalError.NONFINITE_METRICS, "already classified")


def _corrupt_planes(case: str, n_layers: int) -> list:
    """Six ``sample_mixed`` rows of a ``n_layers``-layer CNN as host
    arrays (seg_end, seg_pipe, seg_nce, inter_pipe), broken as ``case``
    says: rows 0 and 1 are one segment, row 2 is [.., 43), [43, 53) of
    ResNet-50 on 4 and 3 CEs."""
    e, p, n, i = (np.array(a) for a in tsamplers.sample_mixed(
        np.random.default_rng(0), n_layers, 6).to_numpy())
    if case == "nce_40":
        n[1, 0] = 40
    elif case == "seg_end_decreasing":              # two rows
        e[2, :2] = [43, 40]
        e[4, 0] = n_layers + 7
    elif case == "gap_before_segment":
        e[2, :3], n[2, :3], p[2, :3] = [20, 20, n_layers], [4, 1, 3], \
            [True, False, True]
    elif case == "last_end_not_n_layers":
        e[3][e[3] == n_layers] = n_layers - 1
    elif case == "pipe_nce_disagree":
        p[2, 0] = False
    elif case == "padding_nce":
        n[2, 5] = 2
    elif case == "ce_total_over_nc":
        n[2, :2] = [10, 7]
    elif case == "plane_lengths":
        p = p[:-1]
    elif case == "float_seg_end":
        e = e.astype(np.float32)
    return [e, p, n, i]


#: corrupted DesignBatches that break rows, and that break the planes
_BROKEN_ROWS = ("nce_40", "seg_end_decreasing", "gap_before_segment",
                "last_end_not_n_layers", "pipe_nce_disagree", "padding_nce",
                "ce_total_over_nc")
_BROKEN_PLANES = ("plane_lengths", "float_seg_end")


@pytest.mark.parametrize("case", ["13_segments", "list_fault",
                                  "batch_fault", "list_eval_error",
                                  *_BROKEN_ROWS, *_BROKEN_PLANES])
def test_session_list_and_batch_errors_use_the_taxonomy(case, monkeypatch):
    """The list and DesignBatch paths raise EvalError too: an input error
    as INVALID_INPUT, the code the JAX package's Session gives on the same
    input; a failure inside the evaluation (a kernel launch on the card)
    as BACKEND_FAULT, with no retry and no fallback.  A corrupted
    DesignBatch never reaches the batch path and is neither retried nor
    counted; a broken row gives the JAX Session's message word for word,
    its count and first index those of the numpy ``validate_batch``."""
    from repro.api import EvalError as JaxEvalError
    from repro.api import Session as JaxSession
    from repro_torch.core import session as port_session
    net = get_cnn("resnet50")
    if case in _BROKEN_ROWS + _BROKEN_PLANES:
        planes = _corrupt_planes(case, len(net))
        with pytest.raises(JaxEvalError) as want:
            JaxSession(jax_get_board("zcu102")).evaluate(
                jenc.DesignBatch(*planes), jax_get_cnn("resnet50"))
        reached = []
        monkeypatch.setattr(port_session, "evaluate_batch",
                            lambda *a, **k: reached.append(a))
        ses = Session(get_board("zcu102"), device="cpu", max_retries=2)
        batch = tenc.DesignBatch(*(torch.as_tensor(a) for a in planes))
        with pytest.raises(EvalError) as got:
            ses.evaluate(batch, net)
        assert got.value.code == want.value.code == EvalError.INVALID_INPUT
        assert reached == []
        assert ses.stats.batch_designs == ses.stats.retried == 0
        if case in _BROKEN_ROWS:
            bad = np.nonzero(~tenc.validate_batch(batch, len(net)))[0]
            assert str(got.value) == str(want.value)
            assert f"{bad.size} invalid DesignBatch row(s), first at index "\
                f"{bad[0]} (" in str(got.value)
        return
    if case == "13_segments":
        with pytest.raises(JaxEvalError) as want:
            JaxSession(jax_get_board("zc706")).evaluate(
                [_SEGMENTS_13], jax_get_cnn("vgg16"))
        with pytest.raises(EvalError) as got:
            Session(get_board("zc706"), device="cpu").evaluate(
                [_SEGMENTS_13], get_cnn("vgg16"))
        assert want.value.code == EvalError.INVALID_INPUT
        assert got.value.code == want.value.code
        assert "more than 12 segments" in str(got.value)
        return
    ses = Session(get_board("zcu102"), device="cpu")
    if case == "list_eval_error":
        # an EvalError from inside passes unchanged, not caused by itself
        monkeypatch.setattr(port_session, "_evaluate_specs", _eval_error)
        with pytest.raises(EvalError) as got:
            ses.evaluate(["{L1-Last:CE1-CE4}"], net)
        assert got.value.code == EvalError.NONFINITE_METRICS
        assert got.value.__cause__ is None
        return
    if case == "list_fault":
        monkeypatch.setattr(port_session, "_evaluate_specs", _fault)
        designs = ["{L1-Last:CE1-CE4}"]
    else:
        monkeypatch.setattr(port_session, "evaluate_batch", _fault)
        monkeypatch.setattr(port_session.time, "sleep", lambda s: None)
        ses = Session(get_board("zcu102"), device="cpu", max_retries=2)
        designs = tsamplers.sample_mixed(np.random.default_rng(0), len(net),
                                         4)
    with pytest.raises(EvalError) as got:
        ses.evaluate(designs, net)
    assert got.value.code == EvalError.BACKEND_FAULT
    assert isinstance(got.value.__cause__, RuntimeError)
    assert "CUDA error 700" in str(got.value)
    if case == "batch_fault":
        # the batch passed its check: counted once over every retry
        assert ses.stats.batch_designs == 4 and ses.stats.retried == 2


def test_port_imports_neither_jax_nor_repro():
    """Importing the port and every one of its modules leaves jax and the
    JAX package out of sys.modules.  A bare ``import repro_torch`` loads
    nothing but the package itself (not torch), and its top-level names
    (``repro_torch.Session``, ``EvalConfig``, ``SessionStats``,
    ``default_session``, ``telemetry``) resolve lazily to the front
    door's."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "assert [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'repro', 'repro_torch')] == ['repro_torch'], "
        "sorted(sys.modules)\n"
        "ses = repro_torch.Session\n"
        "assert 'torch' in sys.modules\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.api\n"
        "for name in repro_torch.__all__:\n"
        "    assert getattr(repro_torch, name) is "
        "getattr(repro_torch.api, name), name\n"
        "assert ses is repro_torch.api.Session\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "mods = sorted(m for m in sys.modules if m.startswith('repro_torch'))"
        "\n"
        "print(len(mods), bad, ' '.join(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad, mods = out.stdout.split(" ", 2)
    assert int(n) >= 20 and bad.strip() == "[]", out.stdout
    # the DSE, serving, schedule, multinet, training and LM mesh slices'
    # modules are among those walked
    for m in ("core.telemetry", "core.resilience", "core.dse.pareto",
              "core.dse.search", "core.dse.driver", "telemetry",
              "core.coalesce", "schedule", "schedule.search",
              "schedule.artifact", "kernels.schedule_score",
              "kernels.schedule_score.ops", "kernels.schedule_score.ref",
              "core.multinet", "core.multinet.partition",
              "core.multinet.joint_eval", "core.multinet.search",
              "core.multinet.driver", "train", "train.optimizer",
              "train.train_step", "train.checkpoint", "data",
              "data.pipeline", "launch.plans", "launch.train",
              "launch.mesh", "launch.steps",
              "models.collectives"):
        assert f"repro_torch.{m}" in mods.split(), m


def test_golden_file_is_current():
    """The committed golden file still equals what the JAX package
    computes.  rtol 1e-6 on the float metrics leaves room only for the
    last bits of a different CPU's vector unit, 10x inside the 1e-5 the
    card is held to."""
    want = compute_golden()
    got = np.load(GOLDEN)
    assert sorted(got.files) == sorted(want)
    for k, w in want.items():
        if k.endswith("/n_ces"):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k)


def test_golden_matches_port_on_cpu():
    """The port on the CPU meets the check chip_smoke.py makes on the
    card, for the ResNet-50/ZCU102 rows of the golden file."""
    golden = np.load(GOLDEN)
    net = get_cnn("resnet50")
    ses = Session(get_board("zcu102"), device="cpu")
    db = tsamplers.sample_mixed(np.random.default_rng(0), len(net), 256)
    got = ses.evaluate(tenc.decode_batch(db, len(net)), net)
    want = {k.rsplit("/", 1)[1]: golden[k] for k in golden.files
            if k.startswith("mixed/resnet50/zcu102/")}
    _assert_metrics(got, want, "golden mixed")
    specs = [port_make_arch(a, net, n) for a in ARCH_NAMES
             for n in (2, 5, 9, 11)]
    want = {k.rsplit("/", 1)[1]: golden[k] for k in golden.files
            if k.startswith("tmpl/resnet50/zcu102/")}
    _assert_metrics(ses.evaluate(specs, net), want, "golden templates")


def test_session_stats_bump_is_atomic():
    """Counters bumped from many threads at once lose no update (plain
    ``+=`` on the fields would)."""
    import threading
    ses = Session(device="cpu")
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            ses.stats.bump("batch_designs") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert ses.stats.batch_designs == 16 * 2000
    assert ses.stats.as_dict()["batch_designs"] == 16 * 2000
    assert {"explore_calls", "retried", "degraded"} <= set(
        ses.stats.as_dict())


def test_session_observability_report():
    net = get_cnn("mobilenetv2")
    ses = Session(get_board("zc706"), device="cpu", max_cached_tables=4)
    ses.evaluate(["{L1-Last:CE1-CE4}"], net)
    obs = ses.observability()
    assert set(obs) == {"compile", "stats", "caches", "breaker",
                        "telemetry"}
    assert obs["caches"] == {
        "net_tables": {"size": 1, "maxsize": 4, "evictions": 0},
        "device_tables": {"size": 1, "maxsize": 4, "evictions": 0},
        "multi_tables": {"size": 0, "maxsize": 4, "evictions": 0},
        "schedule_artifacts": {"size": 0, "maxsize": 4, "evictions": 0}}
    assert obs["breaker"] == {"open": False, "trips": 0}
    assert obs["stats"]["batch_designs"] == 1
    assert obs["compile"]["retried"] == obs["compile"]["degraded"] == 0
