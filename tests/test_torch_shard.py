"""The port's design-axis mesh (``repro_torch.core.shard``) against the JAX
package's ``core/shard.py``, on the CPU.

torch cannot split the host into devices, so a CPU mesh names ``cpu`` once
per shard (``EvalMesh(devices=["cpu"] * 4)``, or ``REPRO_MESH_DEVICES=4``
for a session's mesh): each shard runs the single-device path on its rows,
as each device of a card mesh does.  The padding arithmetic and the
environment parsing equal the JAX package's; a sharded ``evaluate_batch``,
a sharded 4-island search, a sharded ``joint_evaluate`` in every mode and
a ``Session(mesh=4)``'s ``evaluate``, ``explore``, ``deploy`` and
``submit`` equal their unsharded runs bit for bit; the sharded batch path
meets the JAX package's ``evaluate_batch`` (discrete fields exact, rtol
1e-4, 0.04 for ``access_bytes``) and the sharded islands draw the JAX
package's serial islands' designs.
"""
from __future__ import annotations

import importlib
import threading

import numpy as np
import pytest
import torch

import repro.core.coalesce as jcoalesce
import repro.core.shard as jshard
from repro.cnn.registry import CNN_NAMES
from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core import batch_eval as jbe
from repro.core.dse import encoding as jenc
from repro.fpga.boards import get_board as jax_get_board
from repro_torch.api import (EvalConfig, MultinetSearchConfig, SearchConfig,
                             Session, get_board, get_cnn)
from repro_torch.core import batch_eval as tbe
from repro_torch.core import multinet as tmn
from repro_torch.core import session as tsession
from repro_torch.core import shard as tshard
from repro_torch.core.dse import encoding as tenc
from repro_torch.core.dse import sample_mixed
from repro_torch.fpga.archs import ARCH_NAMES, make_arch
from repro_torch.kernels import launches

from test_torch_multinet import _deployments, _mode_kw
from torch_golden import DESIGN_FIELDS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the packages re-export the `search` FUNCTION over the submodule name
jsearch = importlib.import_module("repro.core.dse.search")
tsearch = importlib.import_module("repro_torch.core.dse.search")

CPU4 = ["cpu"] * 4
BOARD = "vcu108"
B = 100
TILE = 8
#: ROADMAP.md's tolerances of the batch path against the JAX package's
RTOL, RTOL_ACCESS = 1e-4, 0.04
#: four islands, the final generation in two sub-rounds (160 = 2 x 64 +
#: 32), migration every generation
ISLANDS = dict(n_islands=4, pop_size=16, budget=160, migration_interval=1,
               migration_elites=2, seed=3)
ISLAND_NET = "mobilenetv2"
TIMEOUT = 120


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_bits(got: dict, want: dict, label: str = "") -> None:
    assert set(got) == set(want), label
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu()), \
                f"{label} {k}"
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {k}")


# --------------------------------------------------------------------------
# padding math and env resolution, against the JAX package
# --------------------------------------------------------------------------
@pytest.mark.parametrize("args", [(100, 8), (100, 8, 1), (100, 8, 4),
                                  (1, 128, 8), (1024, 128, 8),
                                  (1025, 128, 8)])
def test_padded_rows_equal_jax(args):
    """``tests/test_shard.py``'s table."""
    want = jbe.padded_rows(*args)
    assert tbe.padded_rows(*args) == want
    if len(args) == 3:
        mesh = tshard.EvalMesh(devices=["cpu"] * args[2])
        assert mesh.padded_rows(*args[:2]) == want


@pytest.mark.parametrize("raw", [None, "4", "0", "lots"])
def test_env_mesh_devices_equal_jax(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv(tshard.MESH_ENV, raising=False)
    else:
        monkeypatch.setenv(tshard.MESH_ENV, raw)
    assert tshard.MESH_ENV == jshard.MESH_ENV
    assert tshard.MESH_AXIS == jshard.MESH_AXIS
    if raw in ("0", "lots"):
        with pytest.raises(ValueError):
            jshard.env_mesh_devices()
        with pytest.raises(ValueError):
            tshard.env_mesh_devices()
    else:
        assert tshard.env_mesh_devices() == jshard.env_mesh_devices()


def test_mesh_clamps_to_visible_devices(monkeypatch):
    monkeypatch.delenv(tshard.MESH_ENV, raising=False)
    mesh = tshard.EvalMesh(8, device="cpu")
    assert (mesh.ndevices, mesh.requested) == (1, 8)
    assert not mesh.is_sharded and mesh.devices == (torch.device("cpu"),)
    monkeypatch.setenv(tshard.MESH_ENV, "4")
    mesh = tshard.EvalMesh(8, device="cpu")
    assert (mesh.ndevices, mesh.requested) == (4, 8)
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.is_sharded
    assert tshard.EvalMesh(device="cpu").ndevices == 4      # env, then all
    assert tshard.EvalMesh(2, device="cpu").ndevices == 2
    with pytest.raises(ValueError, match="ndevices"):
        tshard.EvalMesh(0, device="cpu")
    explicit = tshard.EvalMesh(devices=CPU4)
    assert (explicit.ndevices, explicit.requested) == (4, 4)


def test_mesh_on_cuda_without_card_raises(monkeypatch):
    """No fallback: a mesh asked for on ``cuda`` with no card raises, as a
    ``cuda`` session does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tshard.EvalMesh(4)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tshard.EvalMesh(devices=["cuda:0"] * 4)
    with pytest.raises(ValueError, match="no mesh"):
        tshard.EvalMesh(device="meta")


@pytest.mark.parametrize("device, first", [("cuda:1", 1), ("cuda", 2)])
def test_card_mesh_starts_at_the_callers_card(device, first, monkeypatch):
    """On a host of three cards, a mesh (and a session's mesh) built for
    ``device`` names that card first, so its outputs gather there; the
    default mesh takes every card."""
    monkeypatch.delenv(tshard.MESH_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    want = tuple(torch.device("cuda", (first + i) % 3) for i in range(3))
    assert tshard.EvalMesh(device=device).devices == want
    assert tshard.EvalMesh(2, device=device).devices == want[:2]
    ses = Session(get_board(BOARD), device=device)
    try:
        assert ses.mesh.devices == want
        assert ses.mesh.devices[0] == torch.device("cuda", first)
    finally:
        ses.close()


def test_shard_call_splits_copies_and_gathers():
    mesh = tshard.EvalMesh(devices=CPU4)
    seen = []

    def fn(rows, table, plane):
        seen.append((rows.shape[0], plane.shape[0], table is not None))
        return {"y": rows * table.sum(), "p": plane + 1}
    rows = torch.arange(8.0)
    out = mesh.shard_call(fn, (rows, torch.ones(3), torch.zeros(4, 2)),
                          replicated=(1,))
    assert seen == [(2, 1, True)] * 4
    assert torch.equal(out["y"], rows * 3) and out["p"].shape == (4, 2)
    assert len(mesh.shard_launches) == 4
    assert all(set(t) == set(launches()) for t in mesh.shard_launches)
    with pytest.raises(ValueError, match="equal shards"):
        mesh.shard_call(fn, (torch.arange(6.0), torch.ones(3),
                             torch.zeros(4, 2)), replicated=(1,))


# --------------------------------------------------------------------------
# the sharded batch path
# --------------------------------------------------------------------------
def _batch(cnn: str):
    """The baseline archs at 2-11 CEs, then sample_mixed rows up to B,
    in both packages' encodings."""
    net = get_cnn(cnn)
    specs = [make_arch(a, net, n) for a in ARCH_NAMES for n in range(2, 12)]
    base = tbe.encode_specs(specs, len(net))
    extra = sample_mixed(np.random.default_rng(11), len(net),
                         B - base.batch)
    db = tenc.concat_batches([base, extra])
    return db, jenc.DesignBatch.from_numpy(*db.to_numpy())


def test_single_device_mesh_is_identity():
    net, board = get_cnn("mobilenetv2"), get_board(BOARD)
    db, _ = _batch("mobilenetv2")
    t = tbe.make_tables(net, device="cpu")
    plain = tbe.evaluate_batch(db, t, board, tile=TILE)
    for mesh in (tshard.EvalMesh(1, device="cpu"), object()):
        _assert_bits(tbe.evaluate_batch(db, t, board, tile=TILE, mesh=mesh),
                     plain, repr(mesh))
    # the board as DeviceTables: its PE count read once, before the shards
    devt = tbe.make_device_tables(board, device="cpu")
    _assert_bits(tbe.evaluate_batch(db, t, devt, tile=TILE,
                                    mesh=tshard.EvalMesh(devices=CPU4)),
                 plain)


def test_copied_setup_evaluates_the_same():
    """What a mesh copies to another device (the net's tables, the board,
    the pair list): every tensor a fresh copy, the copies evaluating the
    same bits as the originals (a clone stands in for a second card)."""
    net, board = get_cnn("mobilenetv2"), get_board(BOARD)
    db, _ = _batch("mobilenetv2")
    t = tbe.make_tables(net, device="cpu")
    setup = (t, *tbe.search_setup(t, board))
    copies = tshard._map(setup, torch.clone)
    assert not any(a is b for a, b in zip(tshard._leaves(copies),
                                          tshard._leaves(setup)))
    _assert_bits(tbe.evaluate_batch(db, copies[0], copies[1], tile=TILE,
                                    pairs=copies[2]),
                 tbe.evaluate_batch(db, t, board, tile=TILE))


def test_sharded_mesh_refuses_per_row_boards():
    """One board a sharded call, as in the JAX package: per-row boards
    take the single-device path."""
    net, board = get_cnn("mobilenetv2"), get_board(BOARD)
    db, _ = _batch("mobilenetv2")
    t = tbe.make_tables(net, device="cpu")
    devt = tbe.make_device_tables(board, device="cpu")
    rows = tbe.DeviceTables(*(getattr(devt, k).expand(db.batch)
                              for k in tbe.DEVICE_TABLE_FIELDS))
    assert rows.per_row
    with pytest.raises(ValueError, match="per-row"):
        tbe.evaluate_batch(db, t, rows, tile=TILE, full_pes=float(board.pes),
                           mesh=tshard.EvalMesh(devices=CPU4))


@pytest.mark.parametrize("cnn", CNN_NAMES)
def test_sharded_evaluate_batch_equals_unsharded_and_jax(cnn):
    net, board = get_cnn(cnn), get_board(BOARD)
    db, jdb = _batch(cnn)
    t = tbe.make_tables(net, device="cpu")
    mesh = tshard.EvalMesh(devices=CPU4)
    got = tbe.evaluate_batch(db, t, board, tile=TILE, mesh=mesh)
    _assert_bits(got, tbe.evaluate_batch(db, t, board, tile=TILE), cnn)
    want = jbe.evaluate_batch(jdb, jbe.make_tables(jax_get_cnn(cnn)),
                              jax_get_board(BOARD), tile=TILE)
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = _np(got[k]), np.asarray(w)
        if k == "n_ces":
            np.testing.assert_array_equal(g, w, err_msg=f"{cnn} {k}")
        else:
            np.testing.assert_allclose(
                g, w, rtol=RTOL_ACCESS if k == "access_bytes" else RTOL,
                err_msg=f"{cnn} {k}")


def test_sharded_spec_list_pads_to_the_mesh_bucket():
    """The list path's bucket is a multiple of ``ndevices x tile``, and
    the sharded list equals the unsharded one."""
    net, board = get_cnn("resnet50"), get_board(BOARD)
    specs = [make_arch(a, net, n) for a in ARCH_NAMES for n in (2, 5, 9)]
    assert tbe._bucket(9, TILE, 4) == jbe._bucket(9, TILE, 4) == 32
    mesh = tshard.EvalMesh(devices=CPU4)
    got = tbe._evaluate_specs(specs, net, board, tile=TILE, device="cpu",
                              mesh=mesh)
    _assert_bits(got, tbe._evaluate_specs(specs, net, board, tile=TILE,
                                          device="cpu"))


# --------------------------------------------------------------------------
# the sharded island step
# --------------------------------------------------------------------------
def _islands(mesh=None, **over):
    return tsearch.search(get_cnn(ISLAND_NET), get_board(),
                          SearchConfig(**{**ISLANDS, **over}), device="cpu",
                          mesh=mesh)


def _assert_same_search(got, want) -> None:
    for f, g, w in zip(DESIGN_FIELDS, got.batch.to_numpy(),
                       want.batch.to_numpy()):
        np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_array_equal(got.points, want.points)
    _assert_bits(got.metrics, want.metrics)
    np.testing.assert_array_equal(got.front_idx, want.front_idx)
    assert len(got.island_fronts) == len(want.island_fronts)
    for g, w in zip(got.island_fronts, want.island_fronts):
        np.testing.assert_array_equal(g, w)
    assert got.history == want.history


def test_sharded_islands_equal_serial_and_jax():
    mesh = tshard.EvalMesh(devices=CPU4)
    sharded, serial = _islands(mesh), _islands()
    _assert_same_search(sharded, serial)
    # four shards, one island each, every step split evenly
    assert len(mesh.shard_launches) == 4
    want = jsearch.search(jax_get_cnn(ISLAND_NET), jax_get_board(),
                          jsearch.SearchConfig(**ISLANDS))
    for f, g, w in zip(DESIGN_FIELDS, sharded.batch.to_numpy(),
                       want.batch.to_numpy()):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)
    np.testing.assert_array_equal(sharded.front_idx, want.front_idx)


def test_n_islands_none_resolves_to_the_mesh():
    mesh = tshard.EvalMesh(devices=CPU4)
    res = _islands(mesh, n_islands=None, budget=96)
    assert len(res.island_fronts) == 4 and res.n_evals == 96
    one = _islands(tshard.EvalMesh(1, device="cpu"), n_islands=None,
                   budget=96)
    assert one.island_fronts == []
    # an island count other than the device count runs the serial loop
    three = _islands(mesh, n_islands=3, budget=96)
    _assert_same_search(three, _islands(n_islands=3, budget=96))


# --------------------------------------------------------------------------
# sharded joint evaluation
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["spatial", "temporal", "hybrid"])
def test_sharded_joint_evaluate_equals_unsharded(mode):
    names = ("resnet50", "mobilenetv2", "densenet121")
    _, md, sh, assign = _deployments(names, 5, n=50)
    mt = tmn.make_multi_tables([get_cnn(c) for c in names],
                               weights=[1.0, 2.0, 1.0],
                               slo_s=[0.12, 0.03, 0.13], device="cpu")
    kw = dict(mode=mode, tile=TILE, **_mode_kw(mode, sh, assign))
    plain = tmn.joint_evaluate(md, mt, get_board("zcu102"), **kw)
    got = tmn.joint_evaluate(md, mt, get_board("zcu102"),
                             mesh=tshard.EvalMesh(devices=CPU4), **kw)
    _assert_bits(got, plain, mode)


# --------------------------------------------------------------------------
# Session(mesh=4)
# --------------------------------------------------------------------------
def test_evalconfig_mesh_resolves_the_env(monkeypatch):
    monkeypatch.setenv(tshard.MESH_ENV, "4")
    assert EvalConfig(device="cpu").resolved().mesh == 4
    assert EvalConfig(device="cpu", mesh=2).resolved().mesh == 2
    monkeypatch.delenv(tshard.MESH_ENV)
    assert EvalConfig(device="cpu").resolved().mesh is None
    with pytest.raises(ValueError, match="mesh"):
        EvalConfig(device="cpu", mesh=0).resolved()


@pytest.fixture(scope="module")
def sessions():
    """A 4-shard CPU session beside an unsharded one."""
    mp = pytest.MonkeyPatch()
    mp.setenv(tshard.MESH_ENV, "4")
    cfg = dict(device="cpu", tile=32, chunk=256)
    sharded = Session(get_board("zc706"), config=EvalConfig(mesh=4, **cfg))
    plain = Session(get_board("zc706"), config=EvalConfig(mesh=1, **cfg))
    mp.undo()
    yield sharded, plain
    sharded.close()
    plain.close()


def test_session_mesh_is_four_cpu_shards(sessions):
    sharded, plain = sessions
    assert sharded.mesh.ndevices == 4 and sharded.mesh.is_sharded
    assert not plain.mesh.is_sharded


def test_session_evaluate_sharded_equals_unsharded(sessions):
    sharded, plain = sessions
    net = get_cnn("resnet50")
    specs = [make_arch(a, net, n) for a in ARCH_NAMES for n in range(2, 12)]
    _assert_bits(sharded.evaluate(specs, net), plain.evaluate(specs, net))
    db = sample_mixed(np.random.default_rng(2), len(net), 300)
    _assert_bits(sharded.evaluate(db, net), plain.evaluate(db, net))


def test_session_explore_sharded_equals_unsharded(sessions):
    sharded, plain = sessions
    net = get_cnn("mobilenetv2")
    a = sharded.explore(net, 300, seed=4, chunk=200)
    b = plain.explore(net, 300, seed=4, chunk=200)
    for g, w in zip(a.batch.to_numpy(), b.batch.to_numpy()):
        np.testing.assert_array_equal(g, w)
    _assert_bits(a.metrics, b.metrics)
    np.testing.assert_array_equal(a.front, b.front)
    cfg = SearchConfig(**{**ISLANDS, "n_islands": None})
    a = sharded.explore(net, 160, strategy="search", config=cfg)
    b = plain.explore(net, 160, strategy="search",
                      config=SearchConfig(**ISLANDS))
    assert len(a.island_fronts) == 4
    for g, w in zip(a.batch.to_numpy(), b.batch.to_numpy()):
        np.testing.assert_array_equal(g, w)
    _assert_bits(a.metrics, b.metrics)
    np.testing.assert_array_equal(a.front, b.front)


def test_session_deploy_sharded_equals_unsharded(sessions):
    sharded, plain = sessions
    nets = [get_cnn("resnet50"), get_cnn("mobilenetv2")]
    cfg = MultinetSearchConfig(pop_size=32, seed=2)
    for strategy in ("search", "random"):
        a = sharded.deploy(nets, 64, strategy=strategy, config=cfg, chunk=48)
        b = plain.deploy(nets, 64, strategy=strategy, config=cfg, chunk=48)
        for g, w in zip(a.designs.to_numpy(), b.designs.to_numpy()):
            np.testing.assert_array_equal(g, w, err_msg=strategy)
        _assert_bits(a.metrics, b.metrics, strategy)
        np.testing.assert_array_equal(a.front, b.front)


def test_session_submit_sharded_equals_unsharded(sessions, monkeypatch):
    """One drain of mixed requests: every future equals the unsharded
    session's, and the megabatch plan is the JAX package's at
    ``ndevices=4``."""
    sharded, plain = sessions
    plans = []
    real = tsession.plan_megabatch

    def spy(keyed, chunk, tile, ndevices=1):
        plan = real(keyed, chunk, tile, ndevices)
        plans.append((list(keyed), chunk, tile, ndevices, plan))
        return plan
    monkeypatch.setattr(tsession, "plan_megabatch", spy)
    rn, mn = get_cnn("resnet50"), get_cnn("mobilenetv2")
    pool = [make_arch(a, rn, n) for a in ARCH_NAMES for n in range(2, 12)]
    reqs = [(pool[:3], rn), (pool * 10, rn), (pool[5:6], rn),
            ([make_arch(ARCH_NAMES[0], mn, 4)], mn)]
    outs = {}
    for ses in (sharded, plain):
        # a finished thread in the drain worker's place: submit starts no
        # drain thread, and the test drains synchronously
        idle = threading.Thread(target=lambda: None)
        idle.start()
        idle.join()
        ses._worker = idle
        futs = [ses.submit(s, n) for s, n in reqs]
        ses.drain()
        outs[id(ses)] = [f.result(timeout=TIMEOUT) for f in futs]
    for g, w in zip(outs[id(sharded)], outs[id(plain)]):
        _assert_bits(g, w)
    keyed, chunk, tile, nd, plan = plans[0]
    assert nd == 4
    want = jcoalesce.plan_megabatch(keyed, chunk, tile, ndevices=4)
    shape = lambda p: ([(c.group, c.rows, c.pad,
                         [(q.req, q.lo, q.hi) for q in c.parts])
                        for c in p.chunks], p.merges, p.splits)
    assert shape(plan) == shape(want)
    assert all(c.pad % (4 * tile) == 0 for c in plan.chunks)
