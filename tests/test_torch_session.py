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


def test_session_evaluate_matches_jax():
    """Session(device="cpu") on a spec list, on notation strings and on a
    DesignBatch against the JAX package's batch path."""
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
    got_m = ses.evaluate(tenc.DesignBatch.from_numpy(*mixed.to_numpy()),
                         net)
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


def test_port_imports_neither_jax_nor_repro():
    """Importing the port and every one of its modules leaves jax and the
    JAX package out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.api\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "n = sum(m.startswith('repro_torch') for m in sys.modules)\n"
        "print(n, bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]", out.stdout


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
