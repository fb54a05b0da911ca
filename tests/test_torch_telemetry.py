"""The port's telemetry (``repro_torch.core.telemetry``) and the resilience
it reports, against the JAX package's, on the CPU.

The two modules give the same histograms, Prometheus text and trace lines
for the same calls; the port's ``Session.evaluate`` and ``explore`` emit
the span, counter, gauge, histogram and event names (and the counts) the
JAX package's emit on the same calls, plus the port's own batch-path
spans; every trace line passes both packages' schema check; the disabled
path records nothing.  The port's spans reach a ``torch.profiler`` trace
with telemetry off, each inside its parent, and chain to
``session.evaluate`` when telemetry is on.  A faulted
kernel is retried and trips the breaker as the JAX package's Session does
with ``fallback_backend=None``, then raises ``BACKEND_FAULT``.
"""
from __future__ import annotations

import math
import time

import numpy as np
import pytest

from faults import CountingHook, inject_fault
from repro.api import EvalError as JaxEvalError
from repro.api import Session as JaxSession
from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core import telemetry as jtel
from repro.core.dse.search import SearchConfig as JaxSearchConfig
from repro.fpga.archs import make_arch as jax_make_arch
from repro.fpga.boards import get_board as jax_get_board
from repro_torch import telemetry as tel_pkg
from repro_torch.api import EvalError, SearchConfig, Session, get_board, \
    get_cnn
from repro_torch.core import telemetry as tel
from repro_torch.core.resilience import CircuitBreaker, retry_delay
from repro_torch.core.telemetry import _NOOP, _REGISTRY, Histogram
from repro_torch.fpga.archs import make_arch

NET, BOARD = "mobilenetv2", "zc706"

#: the spans the port opens on any batch evaluation that the JAX package
#: does not: the batch path's stages
BATCH_SPANS = ("batch.setup", "batch.block", "batch.ce_maps",
               "batch.search", "batch.layer_state", "batch.compose")
#: each new span's parent on one ``evaluate`` of a DesignBatch, which also
#: opens ``session.validate`` and ``session.to_device``
PARENT = {"session.validate": "session.evaluate",
          "session.to_device": "session.evaluate",
          "batch.setup": "session.evaluate",
          "batch.block": "session.evaluate",
          "batch.ce_maps": "batch.block", "batch.search": "batch.block",
          "batch.layer_state": "batch.block",
          "batch.compose": "batch.block"}


@pytest.fixture()
def both_enabled(tmp_path):
    """Both packages' telemetry on, each with a fresh registry and its own
    trace directory; the disabled default restored afterwards."""
    dirs = (tmp_path / "jax", tmp_path / "port")
    for mod, d in zip((jtel, tel), dirs):
        mod.disable()
        mod.reset()
        mod.enable(str(d))
    try:
        yield dirs
    finally:
        for mod in (jtel, tel):
            mod.disable()
            mod.reset()


@pytest.fixture()
def disabled():
    tel.disable()
    tel.reset()
    yield
    tel.disable()
    tel.reset()


def _with_port_spans(names: dict, spans) -> dict:
    """The JAX package's ``names`` (``_names``) with the port's own
    ``spans`` added, and the ``span.<name>.s`` histogram of each."""
    assert not set(spans) & set(names["spans"])
    return dict(names, spans=sorted(set(names["spans"]) | set(spans)),
                histograms=sorted(set(names["histograms"])
                                  | {f"span.{s}.s" for s in spans}))


def _names(mod) -> dict:
    snap = mod.snapshot()
    lines = mod.read_trace(mod.trace_path())
    return {"counters": snap["counters"], "gauges": sorted(snap["gauges"]),
            "histograms": sorted(snap["histograms"]),
            "spans": sorted({l["name"] for l in lines
                             if l["type"] == "span"}),
            "events": sorted({l["name"] for l in lines
                              if l["type"] == "event"})}


# --------------------------------------------------------------------------
# the module against the JAX package's
# --------------------------------------------------------------------------
def test_histograms_equal_jax():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.lognormal(-6, 3, 500), [0.0, 1e9]])
    th, jh = Histogram(), jtel.Histogram()
    for v in vals:
        th.observe(float(v))
        jh.observe(float(v))
    assert th.counts == jh.counts and th.bounds == jh.bounds
    assert th.as_dict() == jh.as_dict()
    bounds = tuple(float(i) for i in range(1, 101))
    h = Histogram(bounds)
    for v in bounds:
        h.observe(v)
    assert (h.percentile(0.5), h.percentile(0.99), h.percentile(1.0)) \
        == (50.0, 99.0, 100.0)
    assert math.isnan(Histogram((1.0,)).percentile(0.5))
    with pytest.raises(ValueError):
        Histogram((2.0, 1.0))


def test_registry_and_trace_lines_equal_jax(both_enabled):
    for mod in (jtel, tel):
        for v in (0.001, 0.002, 0.004):
            mod.observe("lat", v, bounds=(0.001, 0.002, 0.004))
        mod.count("calls", 2)
        mod.gauge("depth", 7)
    # (before any span: a span's duration lands in a histogram)
    assert tel.prometheus_text() == jtel.prometheus_text()
    assert 'repro_lat_bucket{le="0.002"} 2' in tel.prometheus_text()
    for mod in (jtel, tel):
        with mod.span("outer", {"k": "v"}) as outer:
            mod.event("ping", {"i": 3})
            with mod.span("inner") as inner:
                assert inner.parent_id == outer.span_id
                assert mod.current_span() is inner
    jlines = jtel.read_trace(jtel.trace_path())
    tlines = tel.read_trace(tel.trace_path())
    drop = ("t_wall", "dur_s", "trace", "span", "parent")
    strip = lambda l: {k: v for k, v in l.items() if k not in drop
                       and k != "events"}
    assert [strip(l) for l in tlines] == [strip(l) for l in jlines]
    assert [(l["type"], l["name"]) for l in tlines] == [
        ("event", "ping"), ("span", "inner"), ("span", "outer")]
    assert tlines[1]["parent"] == tlines[2]["span"]
    for bad in ([], {"type": "nope"}, {"type": "span", "name": "x"}):
        assert tel.validate_trace_line(bad) == jtel.validate_trace_line(bad)
        assert tel.validate_trace_line(bad) != []


def test_disabled_path_records_nothing(disabled, tmp_path):
    assert tel.span("a", {"k": 1}) is _NOOP and tel.span("b") is _NOOP
    assert tel.current_span() is _NOOP
    tel.count("c")
    tel.gauge("g", 1.0)
    tel.observe("h", 0.5)
    tel.event("e", {"k": "v"})
    with tel.span("s") as s:
        s.set_attr("x", 1)
    net = get_cnn(NET)
    ses = Session(get_board(BOARD), device="cpu")
    ses.evaluate(["{L1-Last:CE1-CE4}"], net)
    ses.explore(net, n=64, strategy="search",
                config=SearchConfig(pop_size=32))
    assert _REGISTRY.size() == 0
    assert tel.trace_path() is None
    snap = tel.snapshot()
    assert snap["enabled"] is False
    assert snap["counters"] == snap["gauges"] == snap["histograms"] == {}
    assert ses.observability()["telemetry"]["enabled"] is False


def test_profile_writes_a_chrome_trace(tmp_path):
    with tel.profile(str(tmp_path)):
        sum(range(1000))
    traces = list(tmp_path.glob("profile-*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    with tel.profile(None):                       # no directory: a no-op
        pass
    assert len(list(tmp_path.iterdir())) == 1


def test_package_reexports_the_core():
    assert tel_pkg.span is tel.span and tel_pkg.snapshot is tel.snapshot
    assert tel_pkg.TELEMETRY_DIR_ENV == jtel.TELEMETRY_DIR_ENV \
        == "REPRO_TELEMETRY_DIR"
    assert tel_pkg.PROFILE_ENV == jtel.PROFILE_ENV


# --------------------------------------------------------------------------
# the Session's telemetry against the JAX package's
# --------------------------------------------------------------------------
def test_session_emits_the_same_names_as_jax(both_enabled):
    """One evaluate (list and scalar), a random explore and a search
    explore on each package's Session: the same span, counter (with equal
    counts), gauge, histogram and event names; every trace line valid
    under both packages' schema."""
    jnet, net = jax_get_cnn(NET), get_cnn(NET)
    js = JaxSession(jax_get_board(BOARD))
    ts = Session(get_board(BOARD), device="cpu")
    for ses, n, arch, cfg in ((js, jnet, jax_make_arch, JaxSearchConfig),
                              (ts, net, make_arch, SearchConfig)):
        ses.evaluate([arch("segmented", n, 4)], n)
        ses.evaluate("{L1-Last:CE1-CE4}", n)
        ses.explore(n, n=64, chunk=32, seed=0)
        ses.explore(n, n=128, strategy="search",
                    config=cfg(pop_size=64, seed=0))
    want, got = _names(jtel), _names(tel)
    assert got == _with_port_spans(want, BATCH_SPANS)
    assert {"session.evaluate", "session.explore"} <= set(got["spans"])
    assert got["events"] == ["dse.generation"]
    assert got["counters"]["dse.generations"] == 2
    for l in tel.read_trace(tel.trace_path()):
        assert jtel.validate_trace_line(l) == []
    gauges = tel.snapshot()["gauges"]
    np.testing.assert_allclose(gauges["dse.hypervolume"],
                               jtel.snapshot()["gauges"]["dse.hypervolume"],
                               rtol=1e-5)
    obs = ts.observability()
    assert set(obs) == {"compile", "stats", "caches", "breaker",
                        "telemetry"}
    assert obs["stats"]["explore_calls"] == 2
    assert obs["telemetry"]["counters"]["session.explore_calls"] == 2
    assert obs["caches"]["net_tables"]["size"] == 1


# --------------------------------------------------------------------------
# the spans on the device trace's clock
# --------------------------------------------------------------------------
def _design_batch(net, n: int = 6):
    from repro_torch.core.dse import sample_mixed
    return sample_mixed(np.random.default_rng(3), len(net), n)


def _profiled_spans(fn) -> dict:
    """``fn()`` under ``torch.profiler``: each host event of a span name
    (``PARENT``'s and ``session.evaluate``) as name -> [(start, end)]."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = set(PARENT) | {"session.evaluate"}
    out: dict[str, list] = {}
    for e in prof.events():
        if e.name in names:
            out.setdefault(e.name, []).append((e.time_range.start,
                                               e.time_range.end))
    return out


def test_the_profiler_flag_exists():
    """The spans reach the profiler through PyTorch's own flag; a PyTorch
    that drops or renames it must fail here, not drop the spans."""
    import torch.autograd.profiler as P
    from torch.profiler import ProfilerActivity, profile
    assert P._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert P._is_profiler_enabled is True
    assert P._is_profiler_enabled is False


def test_spans_reach_the_profiler_with_telemetry_off(disabled):
    """Under ``torch.profiler`` with telemetry off, one ``evaluate`` of a
    DesignBatch puts every span on the trace, each inside its parent,
    and records nothing in the registry or a trace file."""
    net = get_cnn(NET)
    ses = Session(get_board(BOARD), device="cpu")
    batch = _design_batch(net)
    got = _profiled_spans(lambda: ses.evaluate(batch, net))
    assert set(got) == set(PARENT) | {"session.evaluate"}
    for name, parent in PARENT.items():
        for a, b in got[name]:
            assert any(pa <= a and b <= pb for pa, pb in got[parent]), \
                (name, parent)
    assert _REGISTRY.size() == 0
    assert tel.trace_path() is None


@pytest.mark.parametrize("name", ["session.evaluate", *PARENT])
def test_a_span_is_the_noop_without_telemetry_or_profiler(disabled, name):
    assert tel.span(name) is _NOOP
    assert tel.span(name, {"k": 1}) is _NOOP


def test_spans_chain_to_session_evaluate(both_enabled):
    """With telemetry on, the new spans' trace lines pass both packages'
    schema, their parent ids lead to ``session.evaluate``, each has its
    histogram, and under a profiler they reach its trace as well."""
    net = get_cnn(NET)
    ses = Session(get_board(BOARD), device="cpu")
    batch = _design_batch(net)
    got = _profiled_spans(lambda: ses.evaluate(batch, net))
    assert set(got) == set(PARENT) | {"session.evaluate"}
    lines = [l for l in tel.read_trace(tel.trace_path())
             if l["type"] == "span"]
    by_id = {l["span"]: l for l in lines}
    [root] = [l for l in lines if l["name"] == "session.evaluate"]
    assert root["parent"] is None
    for l in lines:
        assert tel.validate_trace_line(l) == []
        assert jtel.validate_trace_line(l) == []
        if l["name"] in PARENT:
            assert by_id[l["parent"]]["name"] == PARENT[l["name"]]
            assert l["trace"] == root["trace"]
    assert set(PARENT) <= {l["name"] for l in lines}
    hist = tel.snapshot()["histograms"]
    for name in PARENT:
        assert hist[f"span.{name}.s"]["count"] == 1


# --------------------------------------------------------------------------
# resilience: retries and the breaker, no fallback
# --------------------------------------------------------------------------
def test_breaker_and_backoff_equal_jax():
    """The backoff schedule, and the breaker's state after each recorded
    fault or success, equal the JAX package's."""
    from repro.core.resilience import CircuitBreaker as JaxBreaker
    from repro.core.resilience import retry_delay as jax_retry_delay
    assert [retry_delay(a) for a in range(8)] \
        == [jax_retry_delay(a) for a in range(8)]
    states = []
    for b in (CircuitBreaker(2), JaxBreaker(2)):
        seen = []
        for step in "fffsfsffff":
            (b.record_failure if step == "f" else b.record_success)()
            seen.append((b.is_open, b.trips))
        states.append(seen)
    assert states[0] == states[1]
    assert states[0][-1] == (True, 2)
    with pytest.raises(ValueError):
        CircuitBreaker(0)


def test_faulted_kernel_is_retried_then_backend_fault(both_enabled,
                                                      monkeypatch):
    """A kernel that always faults: the port's Session retries it
    ``max_retries`` times with backoff, counts ``retried``, trips the
    breaker at its threshold and raises BACKEND_FAULT caused by the fault,
    as the JAX package's Session with ``fallback_backend=None`` does; the
    plain version is never called in its place."""
    from repro_torch.core import session as port_session
    from repro_torch.kernels.mccm_eval import ops as mccm_ops

    calls = {"kernel": 0, "plain": 0}

    def fault(site, route):
        calls["kernel"] += 1
        raise RuntimeError(f"{site} launch failed: CUDA error 700")

    def plain(*args, **kwargs):
        calls["plain"] += 1
        raise AssertionError("the plain version ran in the kernel's place")

    monkeypatch.setattr(mccm_ops, "parallelism_search_ref", plain)
    monkeypatch.setattr(port_session.time, "sleep", lambda s: None)
    monkeypatch.setattr(mccm_ops, "_FAULT_HOOK", fault)
    jnet, net = jax_get_cnn(NET), get_cnn(NET)
    js = JaxSession(jax_get_board(BOARD), backend="pallas_interpret",
                    fallback_backend=None, max_retries=2, design_tile=23)
    ts = Session(get_board(BOARD), device="cpu", max_retries=2)
    with inject_fault(CountingHook(backend="pallas_interpret")) as hook:
        with pytest.raises(JaxEvalError) as want:
            js.evaluate([jax_make_arch("segmented", jnet, 4)], jnet)
    with pytest.raises(EvalError) as got:
        ts.evaluate([make_arch("segmented", net, 4)], net)
    assert got.value.code == want.value.code == EvalError.BACKEND_FAULT
    assert isinstance(got.value.__cause__, RuntimeError)
    assert calls == {"kernel": 3, "plain": 0} and hook.calls == 3
    assert ts.stats.retried == js.stats.retried == 2
    assert ts.stats.degraded == js.stats.degraded == 0
    assert ts.breaker.is_open and js.breaker.is_open
    assert ts.breaker.trips == js.breaker.trips == 1
    jev = {l["name"] for l in jtel.read_trace(jtel.trace_path())
           if l["type"] == "event"}
    tev = {l["name"] for l in tel.read_trace(tel.trace_path())
           if l["type"] == "event"}
    assert tev == jev == {"resilience.retry", "resilience.breaker_open"}
    assert ts.compile_stats()["retried"] == 2
    # the DesignBatch path runs under the same policy; a success closes
    # the breaker again
    from repro_torch.core.dse import sample_mixed
    batch = sample_mixed(np.random.default_rng(0), len(net), 4)
    with pytest.raises(EvalError):
        ts.evaluate(batch, net)
    assert ts.stats.retried == 4 and calls["kernel"] == 6
    monkeypatch.undo()
    ts.evaluate(batch, net)
    assert not ts.breaker.is_open


def test_input_errors_are_not_retried(monkeypatch):
    from repro_torch.core import session as port_session
    monkeypatch.setattr(port_session.time, "sleep", lambda s: None)
    ses = Session(get_board(BOARD), device="cpu", max_retries=3)
    with pytest.raises(EvalError) as e:
        ses.evaluate(["{L1-L9:CE1}"], get_cnn(NET))
    assert e.value.code == EvalError.INVALID_INPUT
    assert ses.stats.retried == 0 and not ses.breaker.is_open
    with pytest.raises(ValueError, match="max_retries"):
        Session(device="cpu", max_retries=-1)


def test_retry_that_recovers_returns_the_result(monkeypatch):
    """One fault, then success: the call returns the metrics the plain
    path gives, with one retry counted and the breaker closed."""
    from repro_torch.core import session as port_session
    real = port_session._evaluate_specs
    n = {"calls": 0}

    def flaky(*args, **kwargs):
        n["calls"] += 1
        if n["calls"] == 1:
            raise RuntimeError("transient launch failure")
        return real(*args, **kwargs)

    sleeps = []
    monkeypatch.setattr(port_session, "_evaluate_specs", flaky)
    monkeypatch.setattr(port_session.time, "sleep", sleeps.append)
    net = get_cnn(NET)
    ses = Session(get_board(BOARD), device="cpu", max_retries=1)
    out = ses.evaluate(["{L1-Last:CE1-CE4}"], net)
    want = Session(get_board(BOARD), device="cpu").evaluate(
        ["{L1-Last:CE1-CE4}"], net)
    for k in want:
        np.testing.assert_array_equal(out[k], want[k])
    assert ses.stats.retried == 1 and sleeps == [retry_delay(1)]
    assert not ses.breaker.is_open


def test_warm_round_adds_no_builds():
    net = get_cnn(NET)
    ses = Session(get_board(BOARD), device="cpu")
    ses.evaluate(["{L1-Last:CE1-CE4}"], net)
    ses.explore(net, n=64, strategy="search",
                config=SearchConfig(pop_size=32))
    before = ses.compile_stats()
    t0 = time.perf_counter()
    ses.evaluate(["{L1-Last:CE1-CE4}"], net)
    ses.explore(net, n=64, strategy="search",
                config=SearchConfig(pop_size=32))
    assert time.perf_counter() - t0 < 60
    after = ses.compile_stats()
    assert after["total"] == before["total"]
    assert after["total"] == after["kernel_builds"] + after["kernel_loads"]
    assert {k for k in after if k.startswith("launches.")} == {
        "launches.parallelism_search", "launches.mccm_latency",
        "launches.conv_ce", "launches.flash_fwd"}
