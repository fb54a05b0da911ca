"""The port's island model (``SearchConfig(n_islands > 1)``, the serial
island loop of ``repro_torch.core.dse.search``) against the JAX package's,
on the CPU.

The port runs the islands one after another through its single-device
generation step, as the JAX package does without a mesh.  From one seed
both packages draw and keep the same designs: every evaluated design,
the merged front, each island's front, the migrants and the archive sizes
of every generation exactly; points and metrics within rtol 1e-5 (the
batch path's gate: the two batch paths part by an f32 ulp on some
designs).  ``golden_islands.npz`` holds the JAX package's runs for the
card, where there is no JAX.
"""
from __future__ import annotations

import importlib
import json

import numpy as np
import pytest
import torch

from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core import telemetry as jtel
from repro.fpga.boards import get_board as jax_get_board
from repro_torch.api import EvalError, SearchConfig, Session, get_board, \
    get_cnn
from repro_torch.core import resilience as tres
from repro_torch.core import telemetry as tel

from torch_golden import DESIGN_FIELDS, GOLDEN_ISLANDS, ISLAND_CNN, \
    ISLAND_RUNS, compute_golden_islands
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the packages re-export the `search` FUNCTION over the submodule name
jsearch = importlib.import_module("repro.core.dse.search")
tsearch = importlib.import_module("repro_torch.core.dse.search")

NET = ISLAND_CNN
RTOL = 1e-5
#: tests/test_shard.py's island configuration (golden run A)
CFG_A = ISLAND_RUNS["A"]
#: two scalarized islands whose remainder (97 = 3 x 32 + 1) leaves island
#: 1 with no rows in the final generation's second sub-round
CFG_SCALAR = dict(n_islands=2, pop_size=16, budget=97, mode="scalarized",
                  migration_interval=1, migration_elites=2, seed=4)
#: tests/test_chaos.py's island2 case: >= 5 generations, so interval-2
#: checkpointing writes twice before the simulated kill
CFG_KILL = dict(n_islands=2, pop_size=16, budget=160, seed=3,
                migration_interval=2, migration_elites=4)



def _port(**kw):
    return tsearch.search(get_cnn(NET), get_board(), SearchConfig(**kw),
                          device="cpu")


def _jax(**kw):
    return jsearch.search(jax_get_cnn(NET), jax_get_board(),
                          jsearch.SearchConfig(**kw))


def _assert_history(got: list, want: list) -> None:
    """Generations, evaluation counts, archive and island-front sizes,
    migrants and the best-scalar index equal; the best objective values
    within the batch gate."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "best"} \
            == {k: v for k, v in w.items() if k != "best"}
        assert g["best"].keys() == w["best"].keys()
        for k in w["best"]:
            np.testing.assert_allclose(g["best"][k], w["best"][k],
                                       rtol=RTOL)


def _assert_same_run(got, designs, points, metrics, front, island_fronts,
                     history) -> None:
    for f, g, w in zip(DESIGN_FIELDS, got.batch.to_numpy(), designs):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)
    np.testing.assert_array_equal(got.front_idx, front)
    assert len(got.island_fronts) == len(island_fronts)
    for g, w in zip(got.island_fronts, island_fronts):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got.points, points, rtol=RTOL)
    assert set(got.metrics) == set(metrics)
    for k, w in metrics.items():
        if k == "n_ces":
            np.testing.assert_array_equal(got.metrics[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got.metrics[k], w, rtol=RTOL,
                                       err_msg=k)
    _assert_history(got.history, history)


@pytest.fixture(scope="module")
def island_result():
    return _port(**CFG_A)


# --------------------------------------------------------------------------
# tests/test_shard.py's island properties, on the port
# --------------------------------------------------------------------------
def test_island_search_is_deterministic(island_result):
    again = _port(**CFG_A)
    np.testing.assert_array_equal(island_result.front_idx, again.front_idx)
    np.testing.assert_array_equal(island_result.points, again.points)
    for a, b in zip(island_result.island_fronts, again.island_fronts):
        np.testing.assert_array_equal(a, b)


def test_island_search_spends_exact_budget(island_result):
    assert island_result.n_evals == CFG_A["budget"]
    assert len(island_result.batch.seg_end) == CFG_A["budget"]
    assert len(island_result.island_fronts) == CFG_A["n_islands"]
    for v in island_result.metrics.values():
        assert v.shape == (CFG_A["budget"],)


def test_migration_transfers_elites(island_result):
    migrated = [h["migrants"] for h in island_result.history]
    assert sum(migrated) > 0, "no generation exchanged elites"
    assert migrated[-1] == 0                    # final gen never breeds
    # migration_interval=2: only every second generation exchanges
    assert all(m == 0 for h, m in zip(island_result.history, migrated)
               if (h["gen"] + 1) % CFG_A["migration_interval"])


def test_merged_front_dominates_island_fronts(island_result):
    merged = island_result.points[island_result.front_idx]
    for fi in island_result.island_fronts:
        assert len(fi) > 0
        for p in island_result.points[fi]:
            assert (merged <= p).all(axis=1).any(), \
                f"island point {p} beats the merged front"


# --------------------------------------------------------------------------
# the port against the JAX package
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [ISLAND_RUNS["B"], CFG_SCALAR],
                         ids=["B", "scalarized2"])
def test_island_search_equals_jax(cfg):
    got, want = _port(**cfg), _jax(**cfg)
    _assert_same_run(got, want.batch.to_numpy(), want.points,
                     {k: np.asarray(v) for k, v in want.metrics.items()},
                     want.front_idx, want.island_fronts, want.history)
    assert [t["gen"] for t in got.timings] == \
        list(range(len(got.history)))


@pytest.mark.parametrize("run", sorted(ISLAND_RUNS))
def test_golden_islands_met_by_port_on_cpu(run):
    """What chip_smoke.py's phase 15 (d) holds the card to, on the CPU."""
    g = np.load(GOLDEN_ISLANDS)
    got = _port(**ISLAND_RUNS[run])
    n_isl = ISLAND_RUNS[run]["n_islands"]
    _assert_same_run(
        got, [g[f"{run}/{f}"] for f in DESIGN_FIELDS], g[f"{run}/points"],
        {k.rsplit("/", 1)[1]: g[k] for k in g.files
         if k.startswith(f"{run}/metric/")},
        g[f"{run}/front"], [g[f"{run}/island/{i}"] for i in range(n_isl)],
        json.loads(str(g[f"{run}/history"])))


def test_golden_islands_is_current():
    """The committed golden_islands.npz still equals what the JAX package
    computes: designs, fronts and history exact, points and metrics within
    rtol 1e-6."""
    want = compute_golden_islands()
    got = np.load(GOLDEN_ISLANDS)
    assert sorted(got.files) == sorted(want)
    for k, w in want.items():
        if k.endswith("/points") or ("/metric/" in k
                                     and not k.endswith("/n_ces")):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


# --------------------------------------------------------------------------
# checkpoint and resume
# --------------------------------------------------------------------------
class _Killed(BaseException):
    """A kill mid-search that neither the loop nor pytest swallows."""


def test_island_search_killed_and_resumed_bit_identical(tmp_path,
                                                        monkeypatch):
    plain = _port(**CFG_KILL)
    path = str(tmp_path / "dse.ckpt")
    real = tres.save_checkpoint
    writes = []

    def save_twice_then_die(*args, **kwargs):
        real(*args, **kwargs)
        writes.append(args[1])
        if len(writes) == 2:
            raise _Killed
    monkeypatch.setattr(tres, "save_checkpoint", save_twice_then_die)
    with pytest.raises(_Killed):
        _port(**CFG_KILL, checkpoint_path=path, checkpoint_interval=2)
    monkeypatch.setattr(tres, "save_checkpoint", real)
    assert writes == ["dse-search-island"] * 2
    snap = tres.load_checkpoint(path, "dse-search-island")["state"]
    assert snap["gen"] == 4 and len(snap["rngs"]) == 2
    got = _port(**CFG_KILL, checkpoint_path=path, checkpoint_interval=2,
                resume=True)
    for f, a, b in zip(DESIGN_FIELDS, got.batch.to_numpy(),
                       plain.batch.to_numpy()):
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(got.points, plain.points)
    np.testing.assert_array_equal(got.front_idx, plain.front_idx)
    for k in plain.metrics:
        np.testing.assert_array_equal(got.metrics[k], plain.metrics[k])
    assert got.history == plain.history
    for a, b in zip(got.island_fronts, plain.island_fronts):
        np.testing.assert_array_equal(a, b)
    # a serial checkpoint is not an island one
    with pytest.raises(EvalError) as e:
        tres.load_checkpoint(path, "dse-search")
    assert e.value.code == EvalError.INVALID_INPUT


def test_checkpoint_fingerprint_binds_migration_fields(tmp_path):
    """The fingerprint holds the two migration fields, so a checkpoint
    written without them (or with others) is refused, not resumed."""
    cfg = SearchConfig(**CFG_KILL, checkpoint_path=str(tmp_path / "c"),
                       resume=True)
    fp = tsearch._cfg_fingerprint(cfg, 53)
    assert fp["migration_interval"] == 2 and fp["migration_elites"] == 4
    assert fp == jsearch._cfg_fingerprint(
        jsearch.SearchConfig(**CFG_KILL), 53)
    old = {k: v for k, v in fp.items()
           if k not in ("migration_interval", "migration_elites")}
    for meta in (old, {**fp, "migration_elites": 3}):
        tres.save_checkpoint(cfg.checkpoint_path, "dse-search-island",
                             {"gen": 1}, meta={"fingerprint": meta})
        with pytest.raises(EvalError) as e:
            _port(**CFG_KILL, checkpoint_path=cfg.checkpoint_path,
                  resume=True)
        assert e.value.code == EvalError.INVALID_INPUT


# --------------------------------------------------------------------------
# the entry points and telemetry
# --------------------------------------------------------------------------
def test_explore_and_submit_search_run_islands():
    """Session.explore and submit_search pass an island config through:
    the result is repro's search(), with the island entries in its
    history."""
    net = get_cnn(NET)
    cfg = SearchConfig(**CFG_SCALAR)
    with Session(get_board(), device="cpu") as ses:
        res = ses.explore(net, n=CFG_SCALAR["budget"], strategy="search",
                          config=cfg)
        job = ses.submit_search(net, CFG_SCALAR["budget"],
                                strategy="search", config=cfg)
        queued = job.result(timeout=300)
    want = _jax(**CFG_SCALAR)
    for f, a, b in zip(DESIGN_FIELDS, res.batch.to_numpy(),
                       want.batch.to_numpy()):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    np.testing.assert_array_equal(res.front, want.front_idx)
    for a, b in zip(res.island_fronts, want.island_fronts):
        np.testing.assert_array_equal(a, b)
    _assert_history(res.history, want.history)
    assert all({"islands", "migrants"} <= h.keys() for h in res.history)
    assert "best_scalar_idx" in res.history[-1]
    assert len(res.island_fronts) == 2
    np.testing.assert_array_equal(queued.front, res.front)
    assert queued.history == res.history


def test_island_count_resolution():
    """None is one population; the count is clamped to the budget; < 1
    is refused, as in the JAX package.  (One-row islands draw their first
    population from sample_mixed: the "both" family's half of one row is
    an empty sample_custom, which both packages refuse.)"""
    one = _port(pop_size=16, budget=48, seed=1)
    assert one.island_fronts == [] and "islands" not in one.history[-1]
    clamped = _port(n_islands=8, pop_size=4, budget=6, seed=1,
                    init_family="mixed")
    assert len(clamped.island_fronts) == 6 and clamped.n_evals == 6
    with pytest.raises(ValueError, match="n_islands"):
        _port(n_islands=0, pop_size=16, budget=48)


def test_island_telemetry_equals_jax(tmp_path):
    """The dse.migrations counter and the generation events' islands /
    migrants attributes, under the JAX package's names and counts."""
    cfg = dict(CFG_SCALAR, mode="pareto")
    for mod, d in ((jtel, tmp_path / "jax"), (tel, tmp_path / "port")):
        mod.disable()
        mod.reset()
        mod.enable(str(d))
    try:
        _jax(**cfg)
        _port(**cfg)
        snaps = [mod.snapshot()["counters"] for mod in (jtel, tel)]
        events = [[(l["attrs"]["gen"], l["attrs"]["islands"],
                    l["attrs"]["migrants"])
                   for l in mod.read_trace(mod.trace_path())
                   if l["name"] == "dse.generation"]
                  for mod in (jtel, tel)]
    finally:
        for mod in (jtel, tel):
            mod.disable()
            mod.reset()
    # the port's batch path also counts the search's unstaged layer rows
    # (none for a zoo network), which the JAX package does not
    assert snaps[1].pop("search.unstaged_rows") == 0
    assert snaps[1] == snaps[0]
    assert snaps[1]["dse.migrations"] > 0
    assert events[1] == events[0] and len(events[1]) == 3
