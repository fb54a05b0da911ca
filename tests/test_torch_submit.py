"""The port's serving lane (``Session.submit`` with the coalesced megabatch
drain, ``submit_search`` and the session lifecycle) against the JAX
package's, on the CPU.

``submit`` results meet the JAX package's ``Session.submit`` on the same
requests (``n_ces`` exact, the rest within rtol 1e-5) and equal the port's
own ``evaluate`` bit for bit; one synchronous ``drain()`` leaves the same
``coalesced_*`` counters.  The cases of ``tests/test_session.py``,
``tests/test_serve_coalesce.py``, ``tests/test_chaos.py`` and
``tests/test_fuzz_inputs.py`` that drive ``submit`` run on both packages
(``pkg`` = ``jax`` or ``port``): isolation of a bad spec, a bad net and a
NaN row in a merged chunk; split requests reassembled in order;
deadlines, ``QUEUE_FULL`` and interactive-before-batch delivery; ``close`` and ``with``; ``default_session``; ``submit_search``
equal to ``explore`` and a checkpointed job resumed bit for bit; the fuzz
contract of ``submit``'s synchronous rejection.  One submit sequence emits
the same telemetry names on both.

Nothing here can hang: every ``Future.result`` has a timeout and every
session is closed by the ``sessions`` fixture.
"""
from __future__ import annotations

import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch
from hypo_fallback import given, settings, st

import repro.api as japi
import repro.core.resilience as jres
import repro.core.session as jsession
import repro_torch.api as tapi
import repro_torch.core.resilience as tres
import repro_torch.core.session as tsession
from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core import telemetry as jtel
from repro.core.dse.search import SearchConfig as JaxSearchConfig
from repro.core.notation import parse as jax_parse
from repro.fpga.archs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.fpga.archs import make_arch as jax_make_arch
from repro.fpga.boards import get_board as jax_get_board
from repro_torch.core import telemetry as ttel
from repro_torch.core.dse.search import SearchConfig
from repro_torch.core.notation import parse
from repro_torch.fpga.archs import ARCH_NAMES, make_arch
from repro_torch.fpga.boards import get_board
from test_torch_telemetry import (  # noqa: F401
    BATCH_SPANS, _names, _with_port_spans, both_enabled)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


NET, BOARD = "mobilenetv2", "zc706"
TIMEOUT = 120
RTOL = 1e-5


class _Pkg:
    """One package's entry points, so a case runs unchanged on both."""

    def __init__(self, name, api, session_mod, res, get_cnn, get_board,
                 make_arch, archs, parse, search_config, kw):
        self.name, self.api, self.session_mod, self.res = \
            name, api, session_mod, res
        self.get_cnn, self.get_board, self.make_arch = \
            get_cnn, get_board, make_arch
        self.archs, self.parse, self.SearchConfig = \
            archs, parse, search_config
        self.kw = kw                      # the port runs on the CPU

    def specs(self, net, n_ces=4):
        return [self.make_arch(a, net, n_ces) for a in self.archs]


PKGS = {
    "jax": _Pkg("jax", japi, jsession, jres, jax_get_cnn, jax_get_board,
                jax_make_arch, JAX_ARCH_NAMES, jax_parse, JaxSearchConfig,
                {}),
    "port": _Pkg("port", tapi, tsession, tres, tapi.get_cnn, get_board,
                 make_arch, ARCH_NAMES, parse, SearchConfig,
                 {"device": "cpu"}),
}


@pytest.fixture
def sessions():
    """``make(pkg, board=None, **config)``: a Session of either package,
    closed when the test ends, whatever happens in it."""
    made = []

    def make(p: _Pkg, board=BOARD, **kw):
        ses = p.api.Session(None if board is None else p.get_board(board),
                            **p.kw, **kw)
        made.append(ses)
        return ses
    try:
        yield make
    finally:
        for ses in made:
            ses.close()


def _no_drain_thread(ses) -> None:
    """Keep ``submit`` from starting the drain thread, so the test drains
    synchronously: a finished thread stands in the worker's place."""
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    ses._worker = t


def _probes(k: int) -> list[str]:
    return [f"{{L1-Last:CE1-CE{1 + (i % 6)}}}" for i in range(k)]


def _assert_equal(got, want, label=""):
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg=f"{label} {k}")


def _assert_near_jax(got, want, label=""):
    for k, w in want.items():
        if k == "n_ces":
            np.testing.assert_array_equal(got[k], np.asarray(w),
                                          err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(got[k], np.asarray(w), rtol=RTOL,
                                       err_msg=f"{label} {k}")


COUNTERS = ("submits", "megabatches", "megabatch_requests",
            "coalesced_chunks", "coalesced_merges", "coalesced_splits",
            "rejected", "deadline_missed", "degraded")


# --------------------------------------------------------------------------
# the port against the JAX package: results and plan counters
# --------------------------------------------------------------------------
def test_submit_equals_jax_and_evaluate(sessions):
    """One synchronous drain of a mixed stream (merged probes, a request
    split at the chunk size, another net in its own group, a scalar
    string) on both packages: the same futures' results, the same
    counters, and the port's futures equal its own evaluate bit for bit."""
    outs, stats, evals = {}, {}, {}
    for name in ("jax", "port"):
        p = PKGS[name]
        net, net2 = p.get_cnn(NET), p.get_cnn("resnet50")
        ses = sessions(p, chunk=64)
        _no_drain_thread(ses)
        big = _probes(150)
        reqs = [([s], net) for s in _probes(5)] + [(big, net)] \
            + [(p.specs(net2), net2)] + [(p.specs(net), net)]
        futs = [ses.submit(d, n) for d, n in reqs]
        futs.append(ses.submit("{L1-Last:CE1-CE3}", net))
        assert ses.drain() == len(futs)
        outs[name] = [f.result(timeout=TIMEOUT) for f in futs]
        stats[name] = {k: getattr(ses.stats, k) for k in COUNTERS}
        evals[name] = [ses.evaluate(d, n) for d, n in reqs]
    assert stats["port"] == stats["jax"]
    assert stats["port"]["coalesced_splits"] == 1
    assert stats["port"]["coalesced_merges"] >= 6
    for i, (got, want) in enumerate(zip(outs["port"], outs["jax"])):
        if isinstance(want["latency_s"], float):
            assert isinstance(got["latency_s"], float)
            got = {k: np.asarray([v]) for k, v in got.items()}
            want = {k: np.asarray([v]) for k, v in want.items()}
        _assert_near_jax(got, want, f"request {i}")
    for i, (got, want) in enumerate(zip(outs["port"][:-1], evals["port"])):
        _assert_equal(got, want, f"request {i}")


# --------------------------------------------------------------------------
# tests/test_session.py's submit cases, on both packages
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_submit_megabatches_and_scalar_result(pkg, sessions):
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p)
    specs = p.specs(net)
    want = ses.evaluate(specs, net)
    futs = [ses.submit(specs, net) for _ in range(3)]
    futs.append(ses.submit("{L1-Last:CE1-CE4}", net))
    outs = [f.result(timeout=TIMEOUT) for f in futs]
    for out in outs[:3]:
        _assert_equal(out, want)
    scalar = outs[-1]
    assert isinstance(scalar["latency_s"], float)
    ref = ses.evaluate(["{L1-Last:CE1-CE4}"], net)
    assert scalar["latency_s"] == float(ref["latency_s"][0])
    assert ses.stats.megabatch_requests == 4
    ses.close()
    with pytest.raises(RuntimeError, match="session closed"):
        ses.submit(specs, net)
    ses.close()                       # idempotent
    with pytest.raises(RuntimeError, match="session closed"):
        ses.submit_search(net, n=64)
    _assert_equal(ses.evaluate(specs, net), want)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_submit_isolates_failing_spec(pkg, sessions):
    """A spec of 13 segments (NS is 12) passes submit and fails at encode
    time: its future alone fails, INVALID_INPUT."""
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p, linger_s=0.2)
    bad = p.parse("{" + ", ".join(f"L{i + 1}:CE{i + 1}" for i in range(13))
                  + ", L14-Last:CE14}", len(net))
    good = p.specs(net)
    f_bad = ses.submit([bad], net)
    f_good = ses.submit(good, net)
    _assert_equal(f_good.result(timeout=TIMEOUT), ses.evaluate(good, net))
    with pytest.raises(p.api.EvalError, match="segments") as ei:
        f_bad.result(timeout=TIMEOUT)
    assert ei.value.code == p.api.EvalError.INVALID_INPUT
    assert ses.stats.degraded == 0


class _BadNet:
    """Parses (submit needs only its length); any table build dies."""

    name = "corrupt"

    def __len__(self):
        return 20

    def __iter__(self):
        raise ValueError("corrupt layer data")

    @property
    def total_macs(self):
        return 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_submit_isolates_bad_net(pkg, sessions):
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p, linger_s=0.2)
    good = p.specs(net)
    f_bad = ses.submit(["{L1-Last:CE1-CE4}"], _BadNet())
    f_good = ses.submit(good, net)
    _assert_equal(f_good.result(timeout=TIMEOUT), ses.evaluate(good, net))
    with pytest.raises(p.api.EvalError, match="corrupt") as ei:
        f_bad.result(timeout=TIMEOUT)
    assert ei.value.code == p.api.EvalError.INVALID_INPUT
    assert ses.stats.megabatches >= 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_submit_hammer_counters_consistent(pkg, sessions):
    """8 threads x 25 submits: every counter bump goes through the stats
    lock, so the totals come out exact."""
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p)
    ses.evaluate("{L1-Last:CE1-CE4}", net)
    futs, errs = [], []
    lock = threading.Lock()

    def hammer():
        mine = []
        try:
            for _ in range(25):
                mine.append(ses.submit("{L1-Last:CE1-CE4}", net))
        except Exception as e:  # noqa: BLE001 — report, don't deadlock
            errs.append(e)
        with lock:
            futs.extend(mine)

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads) and not errs, errs
    for f in futs:
        f.result(timeout=TIMEOUT)
    assert ses.stats.submits == ses.stats.megabatch_requests == 200
    assert ses.stats.rejected == 0 and ses.stats.scalar_evals == 1


# --------------------------------------------------------------------------
# tests/test_serve_coalesce.py's drain cases, on both packages
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_coalesced_probes_equal_evaluate(pkg, sessions):
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p, linger_s=0.25)
    want = ses.evaluate(_probes(8), net)
    futs = [ses.submit([s], net) for s in _probes(8)]
    outs = [f.result(timeout=TIMEOUT) for f in futs]
    assert ses.stats.coalesced_merges >= 2
    assert ses.stats.coalesced_chunks >= 1
    for i, out in enumerate(outs):
        _assert_equal(out, {k: v[i:i + 1] for k, v in want.items()}, i)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_split_request_reassembles_in_order(pkg, sessions):
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p, chunk=32, linger_s=0.05)
    specs = _probes(70)
    out = ses.submit(specs, net).result(timeout=TIMEOUT)
    assert ses.stats.coalesced_splits >= 1
    _assert_equal(out, ses.evaluate(specs, net))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_merged_chunk_nan_fails_only_owner_row(pkg, sessions):
    """Within one merged chunk a NaN in request A's row fails A's future
    only; B, in the same chunk, still delivers."""
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p)
    _no_drain_thread(ses)
    want = ses.evaluate(_probes(2), net)
    # the JAX package evaluates a megabatch in one call returning a dict
    # per chunk; the port calls _evaluate_specs once a chunk
    name = "_evaluate_specs_multi" if pkg == "jax" else "_evaluate_specs"
    real = getattr(p.session_mod, name)

    def poison(out):
        lat = np.asarray(out["latency_s"]).copy()
        lat[0] = np.nan                      # request A owns row 0
        return {**out, "latency_s": lat}

    def poison_first_row(jobs, *a, **kw):
        outs = real(jobs, *a, **kw)
        if pkg == "jax":
            return [poison(outs[0])] + list(outs[1:])
        return poison(outs)

    with mock.patch.object(p.session_mod, name,
                           side_effect=poison_first_row):
        f_a = ses.submit([_probes(2)[0]], net)
        f_b = ses.submit([_probes(2)[1]], net)
        ses.drain()
    with pytest.raises(p.api.EvalError, match="non-finite"):
        f_a.result(timeout=TIMEOUT)
    _assert_equal(f_b.result(timeout=TIMEOUT),
                  {k: v[1:2] for k, v in want.items()})
    assert ses.stats.coalesced_merges == 2


@pytest.mark.parametrize("chunk", [64, 256])
def test_each_chunk_evaluates_at_its_own_pad(chunk, sessions):
    """The port's drain evaluates every planned chunk once, at that
    chunk's own ladder shape (not the megabatch's largest), and the
    futures still equal evaluate bit for bit."""
    p = PKGS["port"]
    net, net2 = p.get_cnn(NET), p.get_cnn("resnet50")
    ses = sessions(p, chunk=chunk, tile=8)
    _no_drain_thread(ses)
    reqs = [([s], net2) for s in _probes(3)] + [(_probes(200), net)]
    want = [ses.evaluate(d, n) for d, n in reqs]
    plan = tsession.plan_megabatch(
        [(n.name, len(d)) for d, n in reqs], chunk, ses.config.tile)
    real, pads = tsession._evaluate_specs, []

    def record(specs, *a, pad_to=None, **kw):
        pads.append((len(specs), pad_to))
        return real(specs, *a, pad_to=pad_to, **kw)

    with mock.patch.object(tsession, "_evaluate_specs", side_effect=record):
        futs = [ses.submit(d, n) for d, n in reqs]
        assert ses.drain() == len(reqs)
    assert pads == [(c.rows, c.pad) for c in plan.chunks]
    assert len({pad for _, pad in pads}) > 1
    for f, w in zip(futs, want):
        _assert_equal(f.result(timeout=TIMEOUT), w)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_interactive_delivered_before_batch(pkg, sessions):
    """One drain: interactive requests are delivered ahead of batch ones,
    each lane in its own queue order."""
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p)
    _no_drain_thread(ses)
    order = []
    lanes = ["batch", "interactive", "batch", "interactive", "interactive"]
    for i, lane in enumerate(lanes):
        f = ses.submit([_probes(6)[i]], net, priority=lane)
        f.add_done_callback(lambda _, i=i: order.append(i))
    with pytest.raises(p.api.EvalError, match="priority") as ei:
        ses.submit([_probes(1)[0]], net, priority="urgent")
    assert ei.value.code == p.api.EvalError.INVALID_INPUT
    assert ses.drain() == 5
    assert order == [1, 3, 4, 0, 2]


# --------------------------------------------------------------------------
# tests/test_chaos.py's deadline and admission cases, on both packages
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_deadline_exceeded_fails_with_its_code(pkg, sessions):
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    with p.api.Session(p.get_board(BOARD), linger_s=0.3, **p.kw) as ses:
        fut = ses.submit("{L1-Last:CE1-CE4}", net, deadline_s=0.01)
        with pytest.raises(p.api.EvalError, match="deadline") as ei:
            fut.result(timeout=TIMEOUT)
        assert ei.value.code == p.api.EvalError.DEADLINE_EXCEEDED
        assert ses.stats.deadline_missed == 1
        out = ses.submit("{L1-Last:CE1-CE4}", net,
                         deadline_s=300.0).result(timeout=TIMEOUT)
        assert np.isfinite(out["latency_s"])
    assert ses.compile_stats()["deadline_missed"] == 1
    assert ses._worker is None


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_queue_full_rejects_with_its_code(pkg, sessions):
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p, max_queue=1, linger_s=1.0)
    f1 = ses.submit(p.specs(net), net)
    with pytest.raises(p.api.EvalError, match="queue full") as ei:
        ses.submit(p.specs(net), net)
    assert ei.value.code == p.api.EvalError.QUEUE_FULL
    assert ses.stats.rejected == 1
    assert ses.compile_stats()["rejected"] == 1
    assert np.isfinite(np.asarray(f1.result(timeout=TIMEOUT)
                                  ["latency_s"])).all()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_config_checks(pkg):
    cfg = PKGS[pkg].api.EvalConfig
    for bad in (dict(max_queue=0), dict(deadline_s=0.0),
                dict(linger_max_s=-1.0)):
        with pytest.raises(ValueError, match=next(iter(bad))):
            cfg(**bad).resolved()
    got = cfg().resolved()
    assert (got.linger_s, got.linger_max_s, got.deadline_s,
            got.max_queue) == (0.002, None, None, None)
    # the port always coalesces: it has no pre-coalescing drain to keep
    assert hasattr(got, "coalesce") == (pkg == "jax")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_adaptive_linger_is_armed_by_the_cap(pkg, sessions):
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p, linger_max_s=0.05)
    assert ses._linger() == 0.05                 # cold: the full window
    futs = [ses.submit([s], net) for s in _probes(4)]
    for f in futs:
        f.result(timeout=TIMEOUT)
    assert 0.0 <= ses._linger() < 0.05
    assert sessions(p)._linger() == 0.002


# --------------------------------------------------------------------------
# the lifecycle
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_with_closes_the_threads(pkg):
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    with p.api.Session(p.get_board(BOARD), **p.kw) as ses:
        fut = ses.submit(p.specs(net), net)
        job = ses.submit_search(net, n=64, chunk=64, seed=1)
        drain, jobs = ses._worker, ses._job_worker
        assert fut.result(timeout=TIMEOUT)["latency_s"].shape == (3,)
        assert job.result(timeout=TIMEOUT).n_evals == 64
    drain.join(timeout=TIMEOUT)
    jobs.join(timeout=TIMEOUT)
    assert not drain.is_alive() and not jobs.is_alive()
    assert ses._worker is None and ses._job_worker is None
    with pytest.raises(RuntimeError, match="session closed"):
        ses.submit(p.specs(net), net)


@pytest.fixture
def fresh_default():
    """Each package's default session unset before and after the test."""
    for p in PKGS.values():
        p.session_mod._DEFAULT = None
    try:
        yield
    finally:
        for p in PKGS.values():
            ses, p.session_mod._DEFAULT = p.session_mod._DEFAULT, None
            if ses is not None:
                ses.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_default_session_is_shared(pkg, fresh_default):
    p = PKGS[pkg]
    ses = p.api.default_session(dev=p.get_board(BOARD), **p.kw)
    assert p.api.default_session() is ses
    with pytest.raises(ValueError, match="already exists"):
        p.api.default_session(chunk=64)
    net = p.get_cnn(NET)
    out = ses.submit("{L1-Last:CE1-CE4}", net).result(timeout=TIMEOUT)
    assert np.isfinite(out["latency_s"])


# --------------------------------------------------------------------------
# the batch lane: submit_search
# --------------------------------------------------------------------------
def test_submit_search_equals_explore_and_jax(sessions):
    """A random job and a search job on the batch lane equal the same
    session's explore, and their designs equal the JAX package's."""
    runs = (dict(n=300, chunk=128, seed=7),
            dict(n=256, strategy="search", seed=2))
    got = {}
    for name in ("jax", "port"):
        p = PKGS[name]
        net = p.get_cnn(NET)
        ses = sessions(p)
        kws = [dict(r) for r in runs]
        kws[1]["config"] = p.SearchConfig(pop_size=64, seed=2)
        futs = [ses.submit_search(net, **kw) for kw in kws]
        jobs = [f.result(timeout=TIMEOUT) for f in futs]
        direct = [ses.explore(net, **kw) for kw in kws]
        for job, want in zip(jobs, direct):
            for g, w in zip(job.batch.to_numpy(), want.batch.to_numpy()):
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(job.front, want.front)
            _assert_equal(job.metrics, want.metrics)
        assert ses.stats.search_jobs == 2
        got[name] = jobs
    for g, w in zip(got["port"], got["jax"]):
        for a, b in zip(g.batch.to_numpy(), w.batch.to_numpy()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g.front, w.front)


class _Crash(RuntimeError):
    """A fault right after a checkpoint write."""


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_checkpointed_job_resumes_bit_identically(pkg, sessions, tmp_path,
                                                  monkeypatch):
    """A checkpointed search job that dies after its first snapshot,
    resubmitted, resumes from it and ends equal to an uninterrupted
    run."""
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p)
    cfg = p.SearchConfig(pop_size=32, seed=2)
    kw = dict(n=256, strategy="search", config=cfg)
    want = ses.explore(net, **kw)
    path = str(tmp_path / "job.ckpt")
    real = p.res.save_checkpoint

    def save_then_crash(*args, **kwargs):
        real(*args, **kwargs)
        raise _Crash("crash after a checkpoint")
    monkeypatch.setattr(p.res, "save_checkpoint", save_then_crash)
    with pytest.raises(p.api.EvalError, match="crash after"):
        ses.submit_search(net, checkpoint_path=path, checkpoint_interval=2,
                          **kw).result(timeout=TIMEOUT)
    monkeypatch.setattr(p.res, "save_checkpoint", real)
    assert p.res.load_checkpoint(path, "dse-search")["state"]["gen"] == 2
    got = ses.submit_search(net, checkpoint_path=path,
                            checkpoint_interval=2, **kw).result(
                                timeout=TIMEOUT)
    for g, w in zip(got.batch.to_numpy(), want.batch.to_numpy()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.front, want.front)
    _assert_equal(got.metrics, want.metrics)
    with pytest.raises(p.api.EvalError, match="strategy='search'") as ei:
        ses.submit_search(net, n=64, checkpoint_path=path)
    assert ei.value.code == p.api.EvalError.INVALID_INPUT


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_search_job_deadline_and_queue(pkg, sessions):
    """A job whose deadline passes while it waits behind another fails
    with DEADLINE_EXCEEDED and spends no budget; admission control
    counts queued jobs."""
    p = PKGS[pkg]
    net = p.get_cnn(NET)
    ses = sessions(p, max_queue=1)
    gate = threading.Event()
    real = ses.explore

    def held(*a, **kw):
        gate.wait(TIMEOUT)
        return real(*a, **kw)
    ses.explore = held
    first = ses.submit_search(net, n=64, chunk=64, seed=0)
    t0 = time.monotonic()
    while not ses._job_running and time.monotonic() - t0 < TIMEOUT:
        time.sleep(0.001)                    # the first job has started
    late = ses.submit_search(net, n=64, chunk=64, seed=1, deadline_s=0.01)
    with pytest.raises(p.api.EvalError, match="queue full") as ei:
        ses.submit_search(net, n=64, chunk=64)
    assert ei.value.code == p.api.EvalError.QUEUE_FULL
    time.sleep(0.05)
    gate.set()
    assert first.result(timeout=TIMEOUT).n_evals == 64
    with pytest.raises(p.api.EvalError, match="deadline") as ei:
        late.result(timeout=TIMEOUT)
    assert ei.value.code == p.api.EvalError.DEADLINE_EXCEEDED
    assert (ses.stats.rejected, ses.stats.deadline_missed,
            ses.stats.search_jobs) == (1, 1, 2)


def test_submit_search_of_many_nets_waits_for_multinet(sessions):
    """``submit_search`` on a list of nets runs ``deploy`` (multinet) on
    the batch lane, on both packages: the port's future resolves to what
    its own ``deploy`` returns, with the JAX package's designs and front."""
    got = {}
    for name, p in PKGS.items():
        ses = sessions(p)
        nets = [p.get_cnn(NET), p.get_cnn("resnet50")]
        got[name] = ses.submit_search(nets, n=64, seed=2).result(
            timeout=TIMEOUT)
        assert ses.stats.search_jobs == 1
        if name == "port":
            want = ses.deploy(nets, n=64, seed=2)
    for res in (want, got["jax"]):
        for g, w in zip(got["port"].designs.to_numpy(),
                        res.designs.to_numpy()):
            np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(got["port"].front, res.front)
    for k, v in want.metrics.items():
        np.testing.assert_array_equal(got["port"].metrics[k], v)


# --------------------------------------------------------------------------
# tests/test_fuzz_inputs.py's submit contract, on both packages
# --------------------------------------------------------------------------
@st.composite
def notation_strings(draw):
    entries = []
    for _ in range(draw(st.integers(min_value=1, max_value=4))):
        lo = draw(st.integers(min_value=0, max_value=40))
        hi = draw(st.sampled_from(
            ["", "-Last", "-last"] + [f"-L{h}" for h in (0, 1, 5, 13, 40)]
            + [f"-{h}" for h in (3, 13)]))
        clo = draw(st.integers(min_value=0, max_value=19))
        chi = draw(st.sampled_from(
            [""] + [f"-CE{c}" for c in (0, 1, 2, 4, 16, 19)]))
        sep = draw(st.sampled_from([":", "", ";"]))
        prefix = draw(st.sampled_from(["L", "", "X"]))
        entries.append(f"{prefix}{lo}{hi}{sep}CE{clo}{chi}")
    wrap = draw(st.sampled_from(["{%s}", "%s", "{%s", "%s}"]))
    return wrap % ", ".join(entries)


@pytest.fixture(scope="module")
def fuzz_sessions():
    made = {name: p.api.Session(p.get_board(BOARD), **p.kw)
            for name, p in PKGS.items()}
    try:
        yield made
    finally:
        for ses in made.values():
            ses.close()


def _submit_outcome(p, ses, text):
    """The fuzz contract: INVALID_INPUT at submit, or finite floats."""
    try:
        fut = ses.submit(text, p.get_cnn("vgg16"))
    except p.api.EvalError as e:
        assert e.code == p.api.EvalError.INVALID_INPUT, e
        return None
    out = fut.result(timeout=TIMEOUT)
    assert np.isfinite(out["latency_s"])
    return out


@settings(max_examples=40, deadline=None)
@given(text=notation_strings())
def test_fuzzed_submit_rejects_synchronously(fuzz_sessions, text):
    got = _submit_outcome(PKGS["port"], fuzz_sessions["port"], text)
    want = _submit_outcome(PKGS["jax"], fuzz_sessions["jax"], text)
    assert (got is None) == (want is None), text
    if got is not None:
        _assert_near_jax({k: np.asarray([v]) for k, v in got.items()},
                         {k: np.asarray([v]) for k, v in want.items()})


# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------
def test_submit_sequence_emits_the_same_names_as_jax(both_enabled):
    """Submits on both lanes (one synchronous drain), a rejection, a
    missed deadline and a search job: the same span, counter (with equal
    counts), gauge, histogram and event names on both packages."""
    for name in ("jax", "port"):
        p = PKGS[name]
        net = p.get_cnn(NET)
        ses = p.api.Session(p.get_board(BOARD), max_queue=3, **p.kw)
        try:
            _no_drain_thread(ses)
            futs = [ses.submit(p.specs(net), net),
                    ses.submit("{L1-Last:CE1-CE4}", net, priority="batch"),
                    ses.submit(_probes(2), net, deadline_s=1e-6)]
            with pytest.raises(p.api.EvalError, match="queue full"):
                ses.submit(_probes(1), net)
            time.sleep(0.01)
            ses.drain()
            for f in futs[:2]:
                f.result(timeout=TIMEOUT)
            with pytest.raises(p.api.EvalError, match="deadline"):
                futs[2].result(timeout=TIMEOUT)
            ses.submit_search(net, n=64, chunk=64).result(timeout=TIMEOUT)
        finally:
            ses.close()
    want, got = _names(jtel), _names(ttel)
    assert got == _with_port_spans(want, BATCH_SPANS)
    assert {"session.submit", "session.megabatch",
            "session.search_job"} <= set(got["spans"])
    assert {"resilience.rejected",
            "resilience.deadline_missed"} <= set(got["events"])
    assert {"session.queue_wait_s", "session.request_latency_s",
            "session.megabatch_fill",
            "session.job_queue_wait_s"} <= set(got["histograms"])
    assert {"session.queue_depth", "session.job_queue_depth",
            "session.megabatch_size",
            "session.linger_s"} <= set(got["gauges"])
    for l in ttel.read_trace(ttel.trace_path()):
        assert jtel.validate_trace_line(l) == []


# --------------------------------------------------------------------------
# chip_smoke.py phase 12 (e) replays benchmarks/serve_load.py's traffic
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed,n", [(0, 64), (3, 24)])
def test_smoke_trace_is_serve_loads_trace(seed, n):
    """The script keeps its own copy of ``make_trace`` (it imports nothing
    of the JAX side): the copy draws the same trace."""
    import importlib.util
    from pathlib import Path

    from benchmarks.serve_load import make_trace
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.serve_trace(seed, n) == make_trace(seed, n)
