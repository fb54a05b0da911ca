"""The port's DSE path (``repro_torch.core.dse`` and ``Session.explore``)
against the JAX package's, on the CPU.

Host breeding (``make_children``, ``_initial_pop``, the boundary
operators), the device repair and validity twins, ``concat_batches`` and
the Pareto functions must equal the JAX package's bit for bit, the RNG
state after each call too.  The generation step meets the JAX package's
jitted step with designs and ``ok`` exact and the points within rtol 1e-5
(the batch path's gate: the two batch paths part by an f32 ulp on some
designs); its score, given the same points, is bit for bit the JAX step's.
``Session(device="cpu").explore`` draws and keeps the same designs and
front as the JAX package's, with the metrics within the batch gate.
"""
from __future__ import annotations

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core import batch_eval as jbe
from repro.core import resilience as jres
from repro.core.dse import driver as jdriver
from repro.core.dse import encoding as jenc
from repro.core.dse.samplers import sample_mixed as jax_sample_mixed
from repro.fpga.boards import get_board as jax_get_board
from repro_torch.api import (DSEResult, EvalError, SearchConfig, Session,
                             get_board, get_cnn, orient, pareto)
from repro_torch.core import batch_eval as tbe
from repro_torch.core import resilience as tres
from repro_torch.core.dse import driver as tdriver
from repro_torch.core.dse import encoding as tenc
from repro_torch.core.dse import search as tsearch_fn

from torch_golden import DESIGN_FIELDS, DSE_RUNS, GOLDEN_DSE, \
    compute_golden_dse
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the packages re-export `search` and `pareto` FUNCTIONS over the
# submodule names
jsearch = importlib.import_module("repro.core.dse.search")
tsearch = importlib.import_module("repro_torch.core.dse.search")
jpareto = importlib.import_module("repro.core.dse.pareto")
tpareto = importlib.import_module("repro_torch.core.dse.pareto")

NET, BOARD = "mobilenetv2", "zc706"
OBJ = ("latency_s", "buffer_bytes")
RTOL = 1e-5



def _assert_designs(got, want, label: str) -> None:
    for f, g, w in zip(DESIGN_FIELDS, got.to_numpy(), want.to_numpy()):
        w = np.asarray(w)
        assert g.dtype == w.dtype, f"{label} {f}"
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {f}")


def _assert_metrics(got: dict, want: dict, label: str) -> None:
    assert set(got) == set(want), label
    for k, w in want.items():
        w = np.asarray(w)
        if k == "n_ces":
            np.testing.assert_array_equal(got[k], w, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                       err_msg=f"{label} {k}")


def _assert_history(got: list, want: list) -> None:
    """Generations, evaluation counts, archive sizes and the best-scalar
    index equal; the best objective values within the batch gate."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "best"} \
            == {k: v for k, v in w.items() if k != "best"}
        assert g["best"].keys() == w["best"].keys()
        for k in w["best"]:
            np.testing.assert_allclose(g["best"][k], w["best"][k],
                                       rtol=RTOL)


def _parents(seed: int, n: int = 200):
    jnet = jax_get_cnn(NET)
    cfg = jsearch.SearchConfig(pop_size=128)
    par = jsearch._initial_pop(np.random.default_rng(seed), len(jnet), cfg,
                               n)
    return len(jnet), par, tenc.DesignBatch.from_numpy(*par.to_numpy())


# --------------------------------------------------------------------------
# host breeding: bit for bit, RNG state included
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_ces", [11, 16, 4])
def test_make_children_equal_jax(seed, max_ces):
    L, jpar, tpar = _parents(seed)
    jcfg = jsearch.SearchConfig(max_ces=max_ces, min_ces=2)
    tcfg = SearchConfig(max_ces=max_ces, min_ces=2)
    jrng, trng = np.random.default_rng(seed + 10), \
        np.random.default_rng(seed + 10)
    want = jsearch.make_children(jrng, jpar, L, jcfg, 300)
    got = tsearch.make_children(trng, tpar, L, tcfg, 300)
    _assert_designs(got, want, "children")
    assert trng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("family,max_ces", [("both", 11), ("custom", 11),
                                            ("mixed", 11), ("both", 1)])
def test_initial_pop_equal_jax(family, max_ces):
    L = len(jax_get_cnn(NET))
    kw = dict(init_family=family, max_ces=max_ces, min_ces=1)
    jrng, trng = np.random.default_rng(4), np.random.default_rng(4)
    want = jsearch._initial_pop(jrng, L, jsearch.SearchConfig(**kw), 257)
    got = tsearch._initial_pop(trng, L, SearchConfig(**kw), 257)
    _assert_designs(got, want, family)
    assert trng.bit_generator.state == jrng.bit_generator.state
    with pytest.raises(ValueError, match="init_family"):
        tsearch._initial_pop(trng, L, SearchConfig(init_family="x"), 4)


@pytest.mark.parametrize("op", ["crossover", "shift", "split", "merge",
                                "nce", "flip", "repair_ces", "boundary"])
def test_boundary_operators_equal_jax(op):
    L, jpar, _ = _parents(5, 160)
    seg_end, _, seg_nce, _ = (np.asarray(a) for a in jpar.to_numpy())
    jb, jn = jsearch._to_boundary(seg_end, seg_nce, L)
    tb, tn = tsearch._to_boundary(seg_end, seg_nce, L)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tn, jn)
    jrng, trng = np.random.default_rng(6), np.random.default_rng(6)
    if op == "crossover":
        want = jsearch._crossover(jrng, jb, jn, jb[::-1], jn[::-1], 0.5)
        got = tsearch._crossover(trng, tb, tn, tb[::-1], tn[::-1], 0.5)
    elif op == "repair_ces":
        wide = np.minimum(seg_nce * 3, 16)             # totals past the cap
        want = (jsearch._repair_ces(seg_end, wide, 3, 11, jrng),)
        got = (tsearch._repair_ces(seg_end, wide, 3, 11, trng),)
    elif op == "boundary":
        want = jsearch._from_boundary(jb, jn, L, max_segments=4)
        got = tsearch._from_boundary(tb, tn, L, max_segments=4)
    else:
        getattr(jsearch, f"_op_{op}")(jrng, jb, jn, 0.7)
        getattr(tsearch, f"_op_{op}")(trng, tb, tn, 0.7)
        want, got = (jb, jn), (tb, tn)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert trng.bit_generator.state == jrng.bit_generator.state


# --------------------------------------------------------------------------
# the device twins of validate/repair, and concat: exact
# --------------------------------------------------------------------------
def _broken_rows(rng, L: int, n: int):
    """Non-canonical rows: unsorted and out-of-range ends, CE counts
    outside [1, NC], pipe flags that disagree with the counts."""
    end = rng.integers(-3, L + 4, size=(n, 12)).astype(np.int32)
    nce = rng.integers(-2, 21, size=(n, 12)).astype(np.int32)
    pipe = rng.random((n, 12)) < 0.5
    inter = rng.random(n) < 0.5
    return end, pipe, nce, inter


def _perturbed_rows(rng, L: int, n: int):
    """Canonical rows with one field of most rows moved by one: an end or
    a CE count up or down, or a pipe flag flipped, in a live segment or
    in padding, so that each condition of the check fails on its own
    (an end moved onto its neighbour leaves an empty segment before a
    non-empty one)."""
    end, pipe, nce, inter = (np.array(a) for a in jax_sample_mixed(
        rng, L, n, min_ces=1, max_ces=16).to_numpy())
    row, col = np.arange(n), rng.integers(0, 12, n)
    which, step = rng.integers(0, 4, n), rng.choice([-1, 1], n)
    for plane, k in ((end, 0), (nce, 1)):
        at = which == k
        plane[row[at], col[at]] += step[at]
    at = which == 2
    pipe[row[at], col[at]] ^= True
    return end, pipe, nce, inter


@pytest.mark.parametrize("kind", ["sampled", "mutated", "broken",
                                  "perturbed"])
@pytest.mark.parametrize("min_ces,max_ces", [(1, 16), (2, 11), (5, 8)])
def test_repair_and_validate_equal_jax(kind, min_ces, max_ces):
    L, jpar, _ = _parents(7)
    rng = np.random.default_rng(8)
    if kind == "sampled":
        arrs = jax_sample_mixed(rng, L, 300, min_ces=1, max_ces=16).to_numpy()
    elif kind == "mutated":
        arrs = jsearch.make_children(rng, jpar, L, jsearch.SearchConfig(),
                                     300).to_numpy()
    elif kind == "broken":
        arrs = _broken_rows(rng, L, 300)
    else:
        arrs = _perturbed_rows(rng, L, 3000)
    jdb = jenc.DesignBatch.from_numpy(*arrs)
    tdb = tenc.DesignBatch.from_numpy(*arrs)
    kw = dict(min_ces=min_ces, max_ces=max_ces)
    want = jenc.repair_batch_jax(jdb, L, **kw)
    got = tenc.repair_batch_torch(tdb, L, **kw)
    _assert_designs(got, want, f"repair {kind}")
    for db_t, db_j in ((tdb, jdb), (got, want)):
        np.testing.assert_array_equal(
            tenc.validate_batch_torch(db_t, L, **kw).numpy(),
            np.asarray(jenc.validate_batch_jax(db_j, L, **kw)))
    if kind != "broken":
        # canonical rows inside the CE bounds come back bit for bit
        ok = tenc.validate_batch_torch(tdb, L, **kw)
        for g, a in zip(got.to_numpy(), tdb.to_numpy()):
            np.testing.assert_array_equal(g[ok.numpy()], a[ok.numpy()])


def test_concat_batches_equal_jax():
    L, jpar, tpar = _parents(9, 50)
    jb = jenc.concat_batches([jpar, jpar.take(np.arange(7))])
    tb = tenc.concat_batches([tpar, tpar.take(slice(0, 7))])
    _assert_designs(tb, jb, "concat")


# --------------------------------------------------------------------------
# Pareto: exact
# --------------------------------------------------------------------------
@pytest.mark.parametrize("m", [2, 3])
def test_pareto_functions_equal_jax(m):
    rng = np.random.default_rng(11)
    pts = rng.random((1500, m))
    pts[::7] = np.round(pts[::7], 1)                 # ties and duplicates
    np.testing.assert_array_equal(pareto(pts), jpareto.pareto(pts))
    np.testing.assert_array_equal(tpareto.knee_point(pts),
                                  jpareto.knee_point(pts))
    np.testing.assert_array_equal(
        tpareto.dominates_matrix(pts[:40], pts[40:90]),
        jpareto.dominates_matrix(pts[:40], pts[40:90]))
    if m == 2:
        ref = np.array([1.1, 1.2])
        assert tpareto.hypervolume_2d(pts, ref) \
            == jpareto.hypervolume_2d(pts, ref)
    ta, ja = tpareto.ParetoArchive(m), jpareto.ParetoArchive(m)
    for lo in range(0, 1500, 100):
        sl = slice(lo, lo + 100)
        np.testing.assert_array_equal(
            ta.update(pts[sl], np.arange(lo, lo + 100)),
            ja.update(pts[sl], np.arange(lo, lo + 100)))
    np.testing.assert_array_equal(ta.points, ja.points)
    np.testing.assert_array_equal(ta.payload, ja.payload)


def test_best_scalar_and_dominating_indices_equal_jax():
    rng = np.random.default_rng(12)
    metrics = {"latency_s": rng.random(500), "buffer_bytes": rng.random(500),
               "throughput_ips": rng.random(500)}
    for obj in (OBJ, ("throughput_ips", "buffer_bytes")):
        assert tdriver.best_scalar_index(metrics, obj) \
            == jdriver.best_scalar_index(metrics, obj)
        np.testing.assert_array_equal(orient(metrics, obj),
                                      jsearch.orient(metrics, obj))
    pts = orient(metrics, OBJ)
    np.testing.assert_array_equal(
        tdriver.dominating_indices(pts, pts[3]),
        jdriver.dominating_indices(pts, pts[3]))


# --------------------------------------------------------------------------
# the generation step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("objectives", [OBJ, ("latency_s", "buffer_bytes",
                                              "throughput_ips")])
def test_search_step_equal_jax(objectives):
    """One padded population of 128 (children, immigrants and rows the
    repair has to fix) through the port's step and the JAX package's
    jitted step."""
    jnet, net = jax_get_cnn(NET), get_cnn(NET)
    L, jpar, _ = _parents(13)
    rng = np.random.default_rng(14)
    # 12 single-CE segments: 12 CEs past max_ces 11, none to take from
    twelve = np.r_[1:12, L].astype(np.int32)[None]
    pop = jenc.concat_batches([
        jsearch.make_children(rng, jpar, L, jsearch.SearchConfig(), 90),
        jax_sample_mixed(rng, L, 20, min_ces=1, max_ces=16),
        jenc.DesignBatch.from_numpy(*_broken_rows(rng, L, 10)),
        jenc.DesignBatch.from_numpy(twelve, np.zeros((1, 12), bool),
                                    np.ones((1, 12), np.int32),
                                    np.ones(1, bool))])
    pop = jbe._pad_rows(pop, 128)
    n_obj = len(objectives)
    w = rng.random(n_obj) + 0.1
    w = w / w.sum()
    jdev = jax_get_board(BOARD)
    jout = jsearch._jitted_step(False)(
        pop.seg_end, pop.seg_pipe, pop.seg_nce, pop.inter_pipe,
        jbe.make_tables(jnet), jbe.make_device_tables(jdev),
        jnp.asarray(w, jnp.float32), jnp.full(n_obj, jnp.inf, jnp.float32),
        jnp.full(n_obj, -jnp.inf, jnp.float32), objectives=objectives,
        min_ces=2, max_ces=11, backend="ref", tile=jbe.DEFAULT_TILE,
        hint=jbe.pes_hint(jdev.pes))
    jdesign, _, jpts, jok, jscore, jlo, jhi = jout
    design, _, pts, ok, score, lo, hi = tsearch.search_step(
        tenc.DesignBatch.from_numpy(*pop.to_numpy()),
        tbe.make_tables(net, device="cpu"),
        tbe.make_device_tables(get_board(BOARD), device="cpu"),
        torch.tensor(w, dtype=torch.float32),
        torch.full((n_obj,), float("inf")), torch.full((n_obj,),
                                                        float("-inf")),
        objectives=objectives, min_ces=2, max_ces=11, tile=128, chunk=2048)
    _assert_designs(design, jenc.DesignBatch(*jdesign), "step design")
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert 0 < int(ok.sum()) < 128
    for g, want in ((pts, jpts), (lo, jlo), (hi, jhi)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=RTOL)
    # the score: bit for bit the JAX step's on the JAX step's own points
    # (XLA's CPU dot order, a fused multiply-add a further objective) ...
    jpts_t, jlo_t, jhi_t = (torch.from_numpy(np.array(a))
                            for a in (jpts, jlo, jhi))
    norm = (jpts_t - jlo_t) / torch.clamp_min(jhi_t - jlo_t, 1e-30)
    fin = np.isfinite(np.asarray(jscore))
    np.testing.assert_array_equal(
        tsearch._weighted_sum(norm, torch.tensor(w, dtype=torch.float32))
        .numpy()[fin], np.asarray(jscore)[fin])
    # ... and within 1e-6 on the port's points (scores lie in [0, 1]; the
    # points part by at most rtol 1e-5)
    np.testing.assert_array_equal(np.isfinite(score.numpy()), fin)
    np.testing.assert_allclose(score.numpy()[fin], np.asarray(jscore)[fin],
                               rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# Session.explore against the JAX package's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("family,n,chunk", [("custom", 999, 256),
                                            ("mixed", 333, 128),
                                            ("both", 333, 128)])
def test_explore_random_equal_jax(family, n, chunk):
    """The paper's custom family at n 999 in chunks of 256, and the other
    two families smaller: the odd n exercises the padded tail."""
    jnet, net = jax_get_cnn(NET), get_cnn(NET)
    want = JaxSession(jax_get_board(BOARD)).explore(
        jnet, n=n, chunk=chunk, seed=5, family=family)
    got = Session(get_board(BOARD), device="cpu").explore(
        net, n=n, chunk=chunk, seed=5, family=family)
    assert isinstance(got, DSEResult) and got.strategy == "random"
    assert got.n_evals == want.n_evals == n
    _assert_designs(got.batch, want.batch, "random")
    np.testing.assert_array_equal(got.front, want.front)
    _assert_metrics(got.metrics, want.metrics, "random")
    assert [t["chunk"] for t in got.timings] == list(range(-(-n // chunk)))
    np.testing.assert_allclose(got.front_points(), want.front_points(),
                               rtol=RTOL)


def test_explore_search_equal_jax():
    """pop 128, budget 512, seed 8: every generation's designs, the front
    and the history equal the JAX package's (no divergence: no near-tie
    of the elite order or of the archive flips at this budget)."""
    jnet, net = jax_get_cnn(NET), get_cnn(NET)
    jdev = jax_get_board(BOARD)
    want = jsearch.search(jnet, jdev, jsearch.SearchConfig(
        pop_size=128, budget=512, seed=8))
    wres = JaxSession(jdev).explore(jnet, n=512, strategy="search",
                                    config=jsearch.SearchConfig(
                                        pop_size=128, seed=8))
    ses = Session(get_board(BOARD), device="cpu")
    got = ses.explore(net, n=512, strategy="search",
                      config=SearchConfig(pop_size=128, seed=8))
    assert got.n_evals == wres.n_evals == 512
    _assert_designs(got.batch, want.batch, "search")
    _assert_designs(got.batch, wres.batch, "search explore")
    np.testing.assert_array_equal(got.front, want.front_idx)
    np.testing.assert_array_equal(got.front, wres.front)
    _assert_metrics(got.metrics, want.metrics, "search")
    _assert_history(got.history, want.history)
    assert [t["gen"] for t in got.timings] == [0, 1, 2, 3]
    # the front is pareto() of the sample, and valid under the config
    np.testing.assert_array_equal(np.sort(got.front),
                                  pareto(orient(got.metrics, OBJ)))
    assert tenc.validate_batch(got.batch, len(net), min_ces=2,
                               max_ces=11).all()
    assert ses.stats.explore_calls == 1


def test_explore_refine_and_islands():
    net = get_cnn(NET)
    ses = Session(get_board(BOARD), device="cpu")
    res = ses.explore(net, n=8, refine="schedule")
    nf = res.front.size
    assert nf >= 1
    assert {k: v.shape for k, v in res.refined.items()} == {
        k: (nf,) for k in ("latency_s", "coarse_latency_s",
                           "throughput_ips", "access_bytes",
                           "coarse_access_bytes", "saving_frac")}
    np.testing.assert_array_equal(res.refined["coarse_latency_s"],
                                  res.metrics["latency_s"][res.front])
    assert (res.refined["latency_s"] <= res.refined["coarse_latency_s"]).all()
    with pytest.raises(EvalError) as e:
        ses.explore(net, n=8, refine="bogus")
    assert e.value.code == EvalError.INVALID_INPUT
    isl = ses.explore(net, n=64, strategy="search",
                      config=SearchConfig(pop_size=32, n_islands=2))
    assert isl.n_evals == 64 and len(isl.island_fronts) == 2
    assert all(len(h["islands"]) == 2 for h in isl.history)
    with pytest.raises(ValueError, match="strategy"):
        ses.explore(net, n=8, strategy="grid")
    assert ses.stats.explore_calls == 3


def test_explore_kernel_fault_is_backend_fault(monkeypatch):
    """A fault inside the search's batch path leaves ``explore`` as
    EvalError(BACKEND_FAULT) and is fed to the breaker; input errors pass
    as they are (a ValueError, as in the JAX package)."""
    from repro_torch.core import batch_eval as be

    def fault(*args, **kwargs):
        raise RuntimeError("parallelism_search launch failed: CUDA error 700")

    net = get_cnn(NET)
    ses = Session(get_board(BOARD), device="cpu")
    monkeypatch.setattr(be, "parallelism_search", fault)
    for _ in range(ses.breaker.fail_threshold):
        with pytest.raises(EvalError) as e:
            ses.explore(net, n=64, strategy="search",
                        config=SearchConfig(pop_size=32))
        assert e.value.code == EvalError.BACKEND_FAULT
        assert isinstance(e.value.__cause__, RuntimeError)
    assert ses.breaker.is_open and ses.breaker.trips == 1
    with pytest.raises(ValueError, match="n must be"):
        ses.explore(net, n=0)


# --------------------------------------------------------------------------
# checkpoint and resume
# --------------------------------------------------------------------------
class _Killed(BaseException):
    """A kill mid-search that neither the loop nor pytest swallows."""


def test_checkpoint_resume_is_bit_identical(tmp_path, monkeypatch):
    net, dev = get_cnn(NET), get_board(BOARD)
    base = dict(pop_size=32, budget=256, seed=2, checkpoint_interval=2)
    want = tsearch_fn(net, dev, SearchConfig(**base), device="cpu")
    path = str(tmp_path / "search.ckpt")
    real = tres.save_checkpoint

    def save_then_die(*args, **kwargs):
        real(*args, **kwargs)
        raise _Killed
    monkeypatch.setattr(tres, "save_checkpoint", save_then_die)
    with pytest.raises(_Killed):
        tsearch_fn(net, dev, SearchConfig(**base, checkpoint_path=path),
                   device="cpu")
    monkeypatch.setattr(tres, "save_checkpoint", real)
    assert tres.load_checkpoint(path, "dse-search")["state"]["gen"] == 2
    got = tsearch_fn(net, dev, SearchConfig(**base, checkpoint_path=path,
                                            resume=True), device="cpu")
    _assert_designs(got.batch, want.batch, "resumed")
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.front_idx, want.front_idx)
    for k in want.metrics:
        np.testing.assert_array_equal(got.metrics[k], want.metrics[k])
    assert got.history == want.history
    assert [t["gen"] for t in got.timings] == list(range(2, 8))
    with pytest.raises(EvalError) as e:
        tsearch_fn(net, dev, SearchConfig(**{**base, "seed": 3},
                                          checkpoint_path=path, resume=True),
                   device="cpu")
    assert e.value.code == EvalError.INVALID_INPUT


def test_checkpoint_files_are_shared_with_jax(tmp_path):
    """The two packages write and read one checkpoint format."""
    state = {"gen": 3, "rng": tres.rng_state(np.random.default_rng(1)),
             "a": np.arange(5)}
    p1, p2 = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    tres.save_checkpoint(p1, "dse-search", state, meta={"x": 1})
    jres.save_checkpoint(p2, "dse-search", state, meta={"x": 1})
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
    got = jres.load_checkpoint(p1, "dse-search")
    assert got["meta"] == {"x": 1} and got["state"]["gen"] == 3
    rng = tres.rng_from_state(tres.load_checkpoint(p2)["state"]["rng"])
    assert rng.random() == np.random.default_rng(1).random()
    with open(p1, "r+b") as f:
        f.seek(-1, 2)
        f.write(b"\0")
    with pytest.raises(tres.EvalError, match="checksum"):
        tres.load_checkpoint(p1)
    with pytest.raises(tres.EvalError, match="kind"):
        tres.load_checkpoint(p2, "other")


# --------------------------------------------------------------------------
# the golden file chip_smoke.py holds the card to
# --------------------------------------------------------------------------
def test_golden_dse_is_current():
    """The committed golden_dse.npz still equals what the JAX package
    computes: designs, ok, fronts and history exact, the front rows'
    metrics within rtol 1e-6."""
    want = compute_golden_dse()
    got = np.load(GOLDEN_DSE)
    assert sorted(got.files) == sorted(want)
    for k, w in want.items():
        if "/front/" in k and not k.endswith("/n_ces"):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_golden_dse_search_matches_port_on_cpu():
    """The port on the CPU meets what chip_smoke.py's phase 11 holds the
    card to on the golden search: every generation's designs and the
    front exactly, the front rows' metrics and the history within the
    batch gate.  (The golden random sweep's designs are host draws,
    covered by the sampler and explore tests above.)"""
    run = "search"
    golden = np.load(GOLDEN_DSE)
    cfg = DSE_RUNS[run]
    res = Session(get_board(), device="cpu").explore(
        get_cnn("mobilenetv2"), n=cfg["n"], strategy="search",
        seed=cfg["seed"], config=SearchConfig(pop_size=cfg["pop_size"],
                                              seed=cfg["seed"]))
    _assert_history(res.history, json.loads(str(golden[f"{run}/history"])))
    for f, g in zip(DESIGN_FIELDS, res.batch.to_numpy()):
        np.testing.assert_array_equal(g, golden[f"{run}/{f}"], err_msg=f)
    np.testing.assert_array_equal(res.front, golden[f"{run}/front"])
    _assert_metrics({k: v[res.front] for k, v in res.metrics.items()},
                    {k.rsplit("/", 1)[1]: golden[k] for k in golden.files
                     if k.startswith(f"{run}/front/")}, run)
