"""The port's schedule layer (``repro_torch.schedule``,
``repro_torch.kernels.schedule_score`` and ``Session.schedule``) against
the JAX package's, on the CPU.

The contracts held here, each on both packages:

* the candidate tables are the JAX package's;
* **bit parity**: the port's plane on the CPU equals the JAX package's
  numpy ``reference_plane`` field by field and in its argmin ``choice``,
  on every baseline arch x CNN (ZC706) and on every board (ResNet-50);
* ``schedule_specs`` meets the JAX package's under ``chip_smoke.py`` phase
  13 (a)'s rules: the discrete and per-layer fields exactly, the composed
  ``ref_*``/``coarse_*`` metrics and ``seg_cyc_*`` within rtol 1e-5 (the two
  batch paths' ``compose_metrics`` part by f32 ulps);
* **never worse**, and refined equal to coarse bit for bit where no
  candidate wins;
* **budget discipline** (property test) on every candidate;
* the artifact: the port's JSON round trip byte-identical, the same keys
  as the JAX package's with the discrete fields equal;
* the ``Session`` surface: ``schedule``'s input checks and memo,
  ``explain``/``explore`` with ``refine="schedule"``, the report, the
  telemetry counters and a faulted scorer raising ``BACKEND_FAULT``;
* ``golden_schedule.npz``, what the card is held to, is current.
"""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from hypo_fallback import given, settings, st
from repro.api import EvalError as JaxEvalError
from repro.api import ScheduleArtifact as JaxScheduleArtifact
from repro.api import Session as JaxSession
from repro.api import format_report as jax_format_report
from repro.cnn.registry import CNN_NAMES
from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core.dse.encoding import encode_specs as jax_encode_specs
from repro.core.workload import make_network as jax_make_network
from repro.fpga.archs import ARCH_NAMES
from repro.fpga.archs import make_arch as jax_make_arch
from repro.fpga.boards import BOARD_NAMES
from repro.fpga.boards import get_board as jax_get_board
from repro.kernels import schedule_score as jscore
from repro.schedule.search import reference_plane
from repro_torch.api import (EvalError, ScheduleArtifact, Session,
                             format_report, get_board, get_cnn, telemetry)
from repro_torch.core.batch_eval import make_device_tables, make_tables
from repro_torch.core.dse.encoding import encode_specs
from repro_torch.core.workload import make_network
from repro_torch.fpga.archs import make_arch
from repro_torch.kernels import schedule_score as tscore
from repro_torch.schedule import build_artifact, device_plane, schedule_specs

from torch_golden import (GOLDEN_SCHEDULE, SCHEDULE_LAYER_FIELDS,
                          TEMPLATE_NS, compute_golden_schedule,
                          schedule_groups)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


BOARD = "zc706"
SPEC = "{L1-Last:CE1-CE4}"
RTOL = 1e-5
#: schedule_specs fields equal to the JAX package's exactly: the discrete
#: ones and the per-layer plane fields (the layer state is bit-equal)
EXACT = ("choice", "ce_of_layer", "seg_of_layer", "pipe_l", "valid_l",
         "seg_valid", "pf_l", "ph_l", "pw_l", "ref_n_ces", "coarse_n_ces",
         "phi", "tile_bytes", "companion_bytes", "floor_bytes",
         "budget_bytes", "lat_ref_l", "lat_coarse_l", "acc_ref_l",
         "acc_coarse_l", "n_tiles_l", "buf_l", "ce_buf_l", "alloc_seg")
#: the artifact's floats that come from the composed metrics (rtol 1e-5),
#: at its top level and in its segments; every other field (a layer's
#: access_bytes included: per-layer, exact) must be equal
TOP_CLOSE = ("latency_s", "coarse_latency_s", "throughput_ips",
             "access_bytes", "coarse_access_bytes", "energy_j",
             "coarse_energy_j", "buffer_bytes")
SEG_CLOSE = ("coarse_cyc", "refined_cyc")


def _templates(make, net):
    return [make(a, net, n) for a in ARCH_NAMES for n in TEMPLATE_NS]


@pytest.fixture(scope="module")
def jax_golden():
    """The JAX package's schedule search over the golden designs: what
    ``golden_schedule.npz`` holds."""
    return compute_golden_schedule()


@pytest.fixture(scope="module")
def port_out():
    """The port's ``schedule_specs`` on the CPU over the same groups, the
    per-layer fields cut to each net's layers."""
    out = {}
    for cnn, board in schedule_groups():
        net = get_cnn(cnn)
        res = schedule_specs(_templates(make_arch, net), net,
                             get_board(board), device="cpu")
        out[(cnn, board)] = {
            k: v[:, :len(net)] if k in SCHEDULE_LAYER_FIELDS else v
            for k, v in res.items()}
    return out


@pytest.fixture(scope="module")
def jses():
    s = JaxSession(jax_get_board(BOARD))
    yield s
    s.close()


@pytest.fixture(scope="module")
def ses():
    s = Session(get_board(BOARD), device="cpu")
    yield s
    s.close()


def assert_artifact_matches(got: dict, want: dict, label: str) -> None:
    """Same keys; the composed-metric floats within rtol 1e-5, every other
    field (the discrete ones, the per-layer plane fields) equal."""
    def close(g, w, where):
        assert math.isclose(g, w, rel_tol=RTOL, abs_tol=0.0), \
            f"{label} {where}: {g} vs {w}"

    assert got.keys() == want.keys(), label
    for k, w in want.items():
        if k in TOP_CLOSE:
            close(got[k], w, k)
        elif k == "segments":
            assert len(got[k]) == len(w), f"{label} segments"
            for gs, ws in zip(got[k], w):
                assert gs.keys() == ws.keys()
                for f, v in ws.items():
                    if f in SEG_CLOSE:
                        close(gs[f], v, f"segment {ws['segment']} {f}")
                    else:
                        assert gs[f] == v, f"{label} segment {f}"
        else:
            assert got[k] == w, f"{label} {k}"


# --------------------------------------------------------------------------
# the candidate space
# --------------------------------------------------------------------------
def test_candidate_tables_equal_jax():
    assert tscore.NCAND == jscore.NCAND == 19
    assert tscore.ORDER_NAMES == jscore.ORDER_NAMES
    assert tscore.FRACS == jscore.FRACS
    assert tscore.BIG == jscore.BIG
    for name in ("CAND_ORDER", "CAND_FRAC", "CAND_DB"):
        g, w = getattr(tscore, name), getattr(jscore, name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert tscore.ref.CAND_META == jscore.ref.CAND_META
    for i in range(tscore.NCAND):
        assert tscore.decode_candidate(i) == jscore.decode_candidate(i)
        assert tscore.candidate_meta(i) == jscore.ops.candidate_meta(i)
    assert tscore.decode_candidate(0) == {
        "order": "ideal", "tile_frac": 1.0, "double_buffer": True}
    seen = {tuple(tscore.decode_candidate(i).items())
            for i in range(tscore.NCAND)}
    assert len(seen) == tscore.NCAND


# --------------------------------------------------------------------------
# bit parity: the port's plane == the JAX package's numpy plane
# --------------------------------------------------------------------------
def _parity(jses, cnn: str, board: str, n: int) -> None:
    """One design a call (the property test below shares the JAX side's
    shapes)."""
    jnet, net = jax_get_cnn(cnn), get_cnn(cnn)
    t = make_tables(net, device="cpu")
    dt = make_device_tables(get_board(board), device="cpu")
    for arch in ARCH_NAMES:
        want, wchoice, _st = reference_plane(
            jax_encode_specs([jax_make_arch(arch, jnet, n)], len(jnet)),
            jses.tables(jnet), jses.device_tables(jax_get_board(board)))
        got = device_plane(encode_specs([make_arch(arch, net, n)],
                                        len(net)), t, dt)
        label = f"{board}/{cnn}/{arch}"
        assert got["choice"].dtype == torch.int32
        np.testing.assert_array_equal(got["choice"].numpy(), wchoice,
                                      err_msg=label)
        assert sorted(got) == sorted([*want, "choice"])
        for k, w in want.items():
            assert got[k].dtype == torch.float32, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                          err_msg=f"{label} field {k}")


@pytest.mark.parametrize("cnn", CNN_NAMES)
def test_plane_equals_reference_every_arch_and_cnn(jses, cnn):
    _parity(jses, cnn, BOARD, 4)


@pytest.mark.parametrize("board", BOARD_NAMES)
def test_plane_equals_reference_every_board(jses, board):
    _parity(jses, "resnet50", board, 6)


# --------------------------------------------------------------------------
# schedule_specs against the JAX package's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("group", schedule_groups(),
                         ids=lambda g: "/".join(g))
def test_schedule_specs_equal_jax(jax_golden, port_out, group):
    got = port_out[group]
    prefix = "sched/" + "/".join(group) + "/"
    want = {k[len(prefix):]: v for k, v in jax_golden.items()
            if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(got[k], w, err_msg=f"{group} {k}")
        else:
            assert k.startswith(("ref_", "coarse_", "seg_cyc_")), k
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=0,
                                       err_msg=f"{group} {k}")


def test_refined_never_worse_and_equal_when_nothing_wins(port_out):
    """Refined latency <= coarse on every golden design, at least one
    design strictly improves, and where no valid layer leaves candidate 0
    the refined metrics equal the coarse ones bit for bit."""
    strict = untouched_rows = 0
    for group, out in port_out.items():
        lat, coarse = out["ref_latency_s"], out["coarse_latency_s"]
        assert np.isfinite(lat).all() and np.isfinite(coarse).all()
        assert not (lat > coarse).any(), group
        strict += int((lat < coarse).sum())
        untouched = ~np.any((out["choice"] != 0) & out["valid_l"], axis=1)
        untouched_rows += int(untouched.sum())
        for k in ("latency_s", "throughput_ips", "access_bytes",
                  "buffer_bytes", "weight_access_bytes", "fm_access_bytes"):
            np.testing.assert_array_equal(out[f"ref_{k}"][untouched],
                                          out[f"coarse_{k}"][untouched])
        np.testing.assert_array_equal(out["seg_cyc_ref"][untouched],
                                      out["seg_cyc_coarse"][untouched])
    assert strict >= 1 and untouched_rows >= 1


# --------------------------------------------------------------------------
# budget discipline (property test)
# --------------------------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(arch=st.sampled_from(ARCH_NAMES),
       n=st.integers(min_value=2, max_value=11),
       board=st.sampled_from(BOARD_NAMES),
       net_name=st.sampled_from(CNN_NAMES))
def test_every_tiling_respects_the_buffer_budget(arch, n, board, net_name):
    """Every candidate of every layer: the tile plus its companion working
    set fits the CE's buffer budget, or the tile is the documented
    minimal-working-set clamp (tile == floor).  The port's plane, equal to
    the JAX package's numpy plane on the same example."""
    jnet, net = jax_get_cnn(net_name), get_cnn(net_name)
    plane = device_plane(
        encode_specs([make_arch(arch, net, n)], len(net)),
        make_tables(net, device="cpu"),
        make_device_tables(get_board(board), device="cpu"))
    jses = _budget_session()
    want, _choice, _st = reference_plane(
        jax_encode_specs([jax_make_arch(arch, jnet, n)], len(jnet)),
        jses.tables(jnet), jses.device_tables(jax_get_board(board)))
    p = {k: v.numpy() for k, v in plane.items()}
    for k in ("tile_bytes", "companion_bytes", "floor_bytes",
              "budget_bytes"):
        np.testing.assert_array_equal(p[k], np.asarray(want[k]))
    tile, comp = p["tile_bytes"], p["companion_bytes"]
    floor, budget = p["floor_bytes"], p["budget_bytes"]
    eps = 1e-3 * np.maximum(budget, 1.0)
    bad = ~((tile + comp <= budget + eps) | (tile <= floor + eps))
    assert not bad.any(), (
        f"{net_name}/{board}/{arch}-{n}: {int(bad.sum())} tiling(s) "
        "overflow their buffer budget without being the floor clamp")


_BUDGET_SES = None


def _budget_session() -> JaxSession:
    """One JAX session for the property test's examples (tables memoized
    across examples)."""
    global _BUDGET_SES
    if _BUDGET_SES is None:
        _BUDGET_SES = JaxSession(jax_get_board(BOARD))
    return _BUDGET_SES


# --------------------------------------------------------------------------
# the artifact
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_artifact_round_trip_and_keys_equal_jax(ses, jses, arch):
    net, jnet = get_cnn("mobilenetv2"), jax_get_cnn("mobilenetv2")
    art = ses.schedule(make_arch(arch, net, 5), net)
    text = art.to_json()
    rt = ScheduleArtifact.from_json(text)
    assert rt == art                      # dataclass equality: every float
    assert rt.to_json() == text           # byte-identical round trip
    assert ScheduleArtifact.from_json(art.to_json(indent=2)) == art
    want = jses.schedule(jax_make_arch(arch, jnet, 5), jnet)
    assert_artifact_matches(json.loads(text), json.loads(want.to_json()),
                            arch)
    assert JaxScheduleArtifact.from_json(text).to_json() == text


def test_artifact_contents_are_consistent(ses):
    net = get_cnn("resnet50")
    art = ses.schedule(make_arch("hybrid", net, 6), net)
    assert art.net == net.name and art.board == BOARD
    assert art.latency_s <= art.coarse_latency_s
    assert art.n_candidates == len(art.layers) * tscore.NCAND
    assert art.meta["n_layers"] == len(net)
    covered = sorted(l.layer for l in art.layers)
    assert covered == sorted(set(covered))
    for ls in art.layers:
        assert ls.order in tscore.ORDER_NAMES
        assert ls.latency_cyc <= ls.coarse_cyc
        assert 0.0 <= ls.phi <= 1.0
    assert sorted(l for p in art.ce_plans for l in p.layers) == covered
    for seg in art.segments:
        assert seg.refined_cyc <= seg.coarse_cyc


def test_golden_artifacts_equal_port(ses, jax_golden):
    """Each CNN's golden artifact (hybrid, 6 CEs, ZC706) against the
    port's."""
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        got = ses.schedule(make_arch("hybrid", net, 6), net)
        assert_artifact_matches(
            json.loads(got.to_json()),
            json.loads(str(jax_golden[f"artifact/{cnn}"])), cnn)


def test_build_artifact_rejects_out_of_range_index(port_out):
    net = get_cnn("mobilenetv2")
    with pytest.raises(IndexError):
        build_artifact(port_out[("mobilenetv2", BOARD)], 10_000, net=net,
                       board_name=BOARD, design_repr="x", wordbytes=1)


# --------------------------------------------------------------------------
# the Session surface
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_session_schedule_validates_input(ses, jses, pkg):
    s, err, net = ((ses, EvalError, get_cnn("mobilenetv2")) if pkg == "port"
                   else (jses, JaxEvalError, jax_get_cnn("mobilenetv2")))
    for bad in ([SPEC, SPEC], "{not notation", "{L1-L9:CE1}"):
        with pytest.raises(err) as ei:
            s.schedule(bad, net)
        assert ei.value.code == err.INVALID_INPUT, bad
    with pytest.raises(EvalError) as ei:
        ses.explain(SPEC, get_cnn("mobilenetv2"), refine="warp")
    assert ei.value.code == EvalError.INVALID_INPUT


def test_explain_refine_schedule_attaches_section(ses, jses):
    net, jnet = get_cnn("mobilenetv2"), jax_get_cnn("mobilenetv2")
    plain = ses.explain(SPEC, net)
    assert "schedule" not in plain
    rep = ses.explain(SPEC, net, refine="schedule")
    want = jses.explain(SPEC, jnet, refine="schedule")
    sched = rep["schedule"]
    assert sched["latency_s"] <= sched["coarse_latency_s"]
    assert 0.0 <= sched["saving_frac"] <= 1.0
    assert len(sched["segments"]) >= 1
    for s in sched["segments"]:
        assert s["refined_cyc"] <= s["coarse_cyc"]
    # the coarse attribution is untouched by the refinement
    for k in ("segments", "ces", "bottleneck", "summary"):
        assert rep[k] == plain[k]
    assert rep.keys() == want.keys()
    assert sched.keys() == want["schedule"].keys()
    for k in ("n_refined_layers",):
        assert sched[k] == want["schedule"][k]
    for k in ("latency_s", "coarse_latency_s", "access_bytes", "energy_j"):
        assert math.isclose(sched[k], want["schedule"][k], rel_tol=RTOL)
    text = format_report(rep)
    assert "schedule refinement" in text
    assert text == jax_format_report(want)
    assert format_report(plain) == jax_format_report(jses.explain(SPEC,
                                                                  jnet))


def test_explore_refine_schedule_rescores_front(ses, jses):
    net, jnet = get_cnn("mobilenetv2"), jax_get_cnn("mobilenetv2")
    res = ses.explore(net, n=256, strategy="random", seed=3,
                      refine="schedule")
    base = ses.explore(net, n=256, strategy="random", seed=3)
    assert base.refined is None
    np.testing.assert_array_equal(res.front, base.front)
    for k, v in base.metrics.items():
        np.testing.assert_array_equal(res.metrics[k], v)
    r = res.refined
    nf = res.front.size
    assert {k: v.shape for k, v in r.items()} == {k: (nf,) for k in r}
    assert (r["latency_s"] <= r["coarse_latency_s"]).all()
    np.testing.assert_array_equal(r["coarse_latency_s"],
                                  base.metrics["latency_s"][base.front])
    want = jses.explore(jnet, n=256, strategy="random", seed=3,
                        refine="schedule")
    np.testing.assert_array_equal(res.front, want.front)
    assert r.keys() == want.refined.keys()
    for k, w in want.refined.items():
        np.testing.assert_allclose(r[k], w, rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    with pytest.raises(EvalError):
        ses.explore(net, n=4, refine="warp")


def _tiny_net(i: int, make=make_network):
    """A distinct 3-layer synthetic net per ``i`` (a distinct memo key),
    built by ``make``, either package's ``make_network``."""
    c = 4 + i
    return make(f"tiny{i}", [
        dict(name="c0", kind="conv", in_ch=3, out_ch=c, kh=3, kw=3,
             stride=1, ih=16, iw=16),
        dict(name="c1", kind="conv", in_ch=c, out_ch=c, kh=3, kw=3,
             stride=2, ih=16, iw=16),
        dict(name="c2", kind="conv", in_ch=c, out_ch=2 * c, kh=1, kw=1,
             stride=1, ih=8, iw=8),
    ])


def test_schedule_memo_bounded_under_design_churn():
    """More distinct designs than the bound: the memo stays at its bound,
    the overflow surfaces as evictions, and a churned-out design rebuilds
    to an equal artifact with no kernel built or loaded."""
    ses = Session(get_board(BOARD), device="cpu", max_cached_tables=3)
    net = _tiny_net(0)
    specs = [f"{{L1-Last:CE1-CE{k}}}" for k in range(1, 9)]
    first = ses.schedule(specs[0], net)
    for s in specs[1:]:
        ses.schedule(s, net)
    caches = ses.observability()["caches"]
    assert caches["schedule_artifacts"]["size"] <= 3
    assert caches["schedule_artifacts"]["maxsize"] == 3
    assert caches["schedule_artifacts"]["evictions"] >= len(specs) - 3
    assert ses.stats.schedule_evictions == \
        caches["schedule_artifacts"]["evictions"]
    builds = ses.stats.schedule_builds
    total = ses.compile_stats()["total"]
    again = ses.schedule(specs[0], net)
    assert ses.stats.schedule_builds == builds + 1
    assert again == first
    assert ses.compile_stats()["total"] == total
    ses.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_schedule_memo_hit_returns_same_object(pkg):
    if pkg == "port":
        s, net = Session(get_board(BOARD), device="cpu"), _tiny_net(1)
    else:
        s = JaxSession(jax_get_board(BOARD))
        net = _tiny_net(1, jax_make_network)
    a = s.schedule(SPEC, net)
    b = s.schedule(SPEC, net)
    assert b is a
    assert (s.stats.schedule_hits, s.stats.schedule_builds,
            s.stats.schedule_calls) == (1, 1, 2)
    s.close()


def test_schedule_telemetry_counters():
    telemetry.disable()
    telemetry.reset()
    telemetry.enable()
    try:
        ses = Session(get_board(BOARD), device="cpu")
        net = get_cnn("mobilenetv2")
        art = ses.schedule(SPEC, net)
        counters = telemetry.snapshot()["counters"]
        assert counters["schedule.searches"] == 1
        assert counters["schedule.candidates"] == art.n_candidates
        assert counters["session.schedule_calls"] == 1
        assert counters["session.schedule_builds"] == 1
        ses.schedule(SPEC, net)              # memo hit: no new search
        counters = telemetry.snapshot()["counters"]
        assert counters["schedule.searches"] == 1
        assert counters["session.schedule_hits"] == 1
        res = ses.explore(net, n=64, seed=1, refine="schedule")
        assert telemetry.snapshot()["counters"]["schedule.candidates"] == \
            art.n_candidates + res.front.size * len(net) * tscore.NCAND
        ses.close()
    finally:
        telemetry.disable()
        telemetry.reset()


def test_faulted_scorer_raises_backend_fault():
    """A raising scorer hook ends in ``BACKEND_FAULT`` after the retries:
    no fallback, nothing degraded, nothing memoized."""
    calls = []

    def hook(site, route):
        calls.append((site, route))
        raise RuntimeError("injected scorer fault")

    prev = tscore.set_fault_hook(hook)
    try:
        ses = Session(get_board(BOARD), device="cpu", max_retries=1)
        net = get_cnn("mobilenetv2")
        with pytest.raises(EvalError) as ei:
            ses.schedule(SPEC, net)
        assert ei.value.code == EvalError.BACKEND_FAULT
        with pytest.raises(EvalError) as ei:
            ses.explain(SPEC, net, refine="schedule")
        assert ei.value.code == EvalError.BACKEND_FAULT
    finally:
        tscore.set_fault_hook(prev)
    assert calls == [("schedule_score", "cpu")] * 4
    assert (ses.stats.retried, ses.stats.degraded) == (2, 0)
    assert ses.stats.schedule_builds == 0
    assert ses.cache_stats()["schedule_artifacts"]["size"] == 0
    ses.close()


def test_golden_schedule_is_current(jax_golden):
    """The committed golden file still equals what the JAX package
    computes (rtol 1e-6 on the composed floats, for another CPU's vector
    unit; every other field exactly)."""
    got = np.load(GOLDEN_SCHEDULE)
    assert sorted(got.files) == sorted(jax_golden)
    for k, w in jax_golden.items():
        g = got[k]
        if k.startswith("artifact/"):
            assert_artifact_matches(json.loads(str(g)), json.loads(str(w)),
                                    k)
        elif k.rsplit("/", 1)[1] in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)
