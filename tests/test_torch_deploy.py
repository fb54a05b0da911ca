"""The port's multinet DSE (``Session.deploy``, ``joint_search``, the
``submit_search`` lane on a list of nets) against the JAX package's, on
the CPU.

Every arm of ``Session(device="cpu").deploy`` at a small budget draws the
same designs and raw shares as ``repro``'s ``Session.deploy`` bit for bit,
keeps the same front, and meets its metrics within rtol 1e-5 (the
integer splits and the assignment exactly).  A checkpointed search
resumes bit for bit; ``submit_search`` on a list of nets resolves to
``deploy``'s result; the session memoizes the tables and counts it; a
kernel fault ends as ``EvalError(BACKEND_FAULT)``.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.api import Session as JaxSession
from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core.multinet import MultinetSearchConfig as JaxConfig
from repro.fpga.boards import get_board as jax_get_board
from repro_torch import telemetry
from repro_torch.api import (EvalError, JointDSEResult, MultinetSearchConfig,
                             Session, get_board, get_cnn)
from repro_torch.core import resilience as tres
from repro_torch.core.multinet import joint_evaluate, joint_search

from torch_golden import DESIGN_FIELDS, GOLDEN_MULTINET, MULTINET_DEPLOY
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5
NETS, BOARD = ("resnet50", "mobilenetv2"), "zc706"
#: per arm: (budget, pop_size, extra config): 5 generations, so the last
#: breeding is the memetic (exploit) one
BUDGET, POP = 640, 128
SLO = (0.08, 0.02)
ARMS = {"search": {}, "equal_split": {}, "temporal": {},
        "hybrid": dict(objective="slo", slo_s=SLO), "random": {}}
#: the M = 3 hybrid study of benchmarks/multinet_hybrid.py, small
HYBRID3 = (("resnet50", "mobilenetv2", "densenet121"),
           dict(objective="slo", slo_s=(0.120, 0.030, 0.130),
                weights=(1.0, 2.0, 1.0)))
EXACT = ("pes_split", "buf_split", "assign")



def _deploy(ses, get, names, arm, extra, budget=BUDGET, pop=POP, cfg=None):
    nets = [get(c) for c in names]
    if arm == "random":
        return ses.deploy(nets, budget, strategy="random", seed=3,
                          chunk=pop)
    return ses.deploy(nets, budget, strategy=arm,
                      config=cfg(pop_size=pop, seed=3, **extra))


@pytest.fixture(scope="module")
def jax_runs():
    """``repro``'s ``Session.deploy`` per arm, computed once (one jit
    compile per mode serves them all)."""
    ses = JaxSession(jax_get_board(BOARD))
    runs = {arm: _deploy(ses, jax_get_cnn, NETS, arm, extra, cfg=JaxConfig)
            for arm, extra in ARMS.items()}
    runs["hybrid3"] = _deploy(ses, jax_get_cnn, HYBRID3[0], "hybrid",
                              HYBRID3[1], budget=384, cfg=JaxConfig)
    ses.close()
    return runs


def _assert_same(got: JointDSEResult, want, label: str) -> None:
    for g, w in zip(got.designs.to_numpy(), want.designs.to_numpy()):
        assert g.dtype == np.asarray(w).dtype, label
        np.testing.assert_array_equal(g, w, err_msg=f"{label} designs")
    assert set(got.shares) == set(want.shares), label
    for k, w in want.shares.items():
        np.testing.assert_array_equal(got.shares[k], w,
                                      err_msg=f"{label} shares {k}")
    np.testing.assert_array_equal(got.front, want.front,
                                  err_msg=f"{label} front")
    assert got.objectives == tuple(want.objectives), label
    assert (got.strategy, got.mode, got.n_evals, got.n_models) == (
        want.strategy, want.mode, want.n_evals, want.n_models), label
    assert set(got.metrics) == set(want.metrics), label
    for k, w in want.metrics.items():
        w = np.asarray(w)
        assert got.metrics[k].shape == w.shape, (label, k)
        if k in EXACT:
            np.testing.assert_array_equal(got.metrics[k], w,
                                          err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(got.metrics[k], w, rtol=RTOL,
                                       err_msg=f"{label} {k}")
    np.testing.assert_allclose(got.front_points(), want.front_points(),
                               rtol=RTOL)


@pytest.mark.parametrize("arm", list(ARMS))
def test_deploy_arm_equal_jax(arm, jax_runs):
    ses = Session(get_board(BOARD), device="cpu")
    got = _deploy(ses, get_cnn, NETS, arm, ARMS[arm],
                  cfg=MultinetSearchConfig)
    _assert_same(got, jax_runs[arm], arm)
    assert got.per_eval_us > 0 and len(got.timings) == (
        BUDGET // POP)
    if arm == "hybrid":
        assert got.objectives == ("slo_attainment_dist",
                                  "agg_throughput_ips")
        assert got.metrics["assign"].shape == (BUDGET, 4)


def test_deploy_hybrid_m3_weights_equal_jax(jax_runs):
    """The 3-model hybrid study's settings (SLOs, a 1:2:1 request mix)."""
    ses = Session(get_board(BOARD), device="cpu")
    got = _deploy(ses, get_cnn, HYBRID3[0], "hybrid", HYBRID3[1],
                  budget=384, cfg=MultinetSearchConfig)
    _assert_same(got, jax_runs["hybrid3"], "hybrid3")
    mt = ses.multi_tables([get_cnn(c) for c in HYBRID3[0]],
                          weights=HYBRID3[1]["weights"],
                          slo_s=HYBRID3[1]["slo_s"])
    np.testing.assert_allclose(mt.normalized_weights, [0.25, 0.5, 0.25])
    assert ses.stats.multi_table_hits == 1


def test_search_row_reevaluates_to_its_metrics():
    """Re-feeding a front deployment's raw share genome to
    ``joint_evaluate`` reproduces its archived metrics bit for bit."""
    nets = [get_cnn(c) for c in NETS]
    ses = Session(get_board(BOARD), device="cpu")
    res = ses.deploy(nets, 256, config=MultinetSearchConfig(pop_size=128,
                                                            seed=9))
    i = int(res.front[0])
    out = joint_evaluate(res.designs.take(np.array([i])),
                         ses.multi_tables(nets), get_board(BOARD),
                         pes_shares=res.shares["pes"][i][None],
                         buf_shares=res.shares["buf"][i][None],
                         bw_shares=res.shares["bw"][i][None])
    for k in ("worst_latency_s", "pes_split", "per_model_latency_s"):
        np.testing.assert_array_equal(out[k][0].numpy(), res.metrics[k][i],
                                      err_msg=k)


# --------------------------------------------------------------------------
# checkpoint and resume
# --------------------------------------------------------------------------
class _Killed(BaseException):
    """A kill mid-search that neither the loop nor pytest swallows."""


@pytest.mark.parametrize("mode", ["spatial", "hybrid"])
def test_checkpoint_resume_is_bit_identical(mode, tmp_path, monkeypatch):
    nets, dev = [get_cnn(c) for c in NETS], get_board(BOARD)
    base = dict(pop_size=32, budget=192, seed=2, checkpoint_interval=2,
                mode=mode)
    want = joint_search(nets, dev, MultinetSearchConfig(**base),
                        device="cpu")
    path = str(tmp_path / "multinet.ckpt")
    real = tres.save_checkpoint

    def save_then_die(*args, **kwargs):
        real(*args, **kwargs)
        raise _Killed
    monkeypatch.setattr(tres, "save_checkpoint", save_then_die)
    with pytest.raises(_Killed):
        joint_search(nets, dev, MultinetSearchConfig(
            **base, checkpoint_path=path), device="cpu")
    monkeypatch.setattr(tres, "save_checkpoint", real)
    assert tres.load_checkpoint(path, "multinet-search")["state"]["gen"] \
        == 2
    got = joint_search(nets, dev, MultinetSearchConfig(
        **base, checkpoint_path=path, resume=True), device="cpu")
    for g, w in zip(got.designs.to_numpy(), want.designs.to_numpy()):
        np.testing.assert_array_equal(g, w)
    for k in want.shares:
        np.testing.assert_array_equal(got.shares[k], want.shares[k])
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.front_idx, want.front_idx)
    for k in want.metrics:
        np.testing.assert_array_equal(got.metrics[k], want.metrics[k])
    assert got.history == want.history
    assert [t["gen"] for t in got.timings] == list(range(2, 6))
    with pytest.raises(EvalError) as e:
        joint_search(nets, dev, MultinetSearchConfig(
            **{**base, "seed": 3}, checkpoint_path=path, resume=True),
            device="cpu")
    assert e.value.code == EvalError.INVALID_INPUT


# --------------------------------------------------------------------------
# the session: submit_search on a list, the memo, telemetry, faults
# --------------------------------------------------------------------------
def test_submit_search_on_a_list_equals_deploy(tmp_path):
    nets = [get_cnn(c) for c in NETS]
    cfg = MultinetSearchConfig(pop_size=64, seed=4)
    with Session(get_board(BOARD), device="cpu") as ses:
        want = ses.deploy(nets, 192, config=cfg)
        futs = [ses.submit_search(nets, 192, config=cfg),
                ses.submit_search(nets, 96, strategy="random", seed=1,
                                  chunk=48)]
        got = [f.result(timeout=300) for f in futs]
        rnd = ses.deploy(nets, 96, strategy="random", seed=1, chunk=48)
        # a checkpointed job resumes; the default config takes the seed
        path = str(tmp_path / "job.ckpt")
        job = ses.submit_search(nets, 192, seed=4, checkpoint_path=path,
                                checkpoint_interval=1)
        ck = job.result(timeout=300)
        with pytest.raises(EvalError) as e:
            ses.submit_search(nets, 64, strategy="random",
                              checkpoint_path=path)
        assert e.value.code == EvalError.INVALID_INPUT
        assert ses.stats.search_jobs == 3
    for g, w in ((got[0], want), (got[1], rnd)):
        assert isinstance(g, JointDSEResult)
        for a, b in zip(g.designs.to_numpy(), w.designs.to_numpy()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g.front, w.front)
        for k in w.metrics:
            np.testing.assert_array_equal(g.metrics[k], w.metrics[k])
    for a, b in zip(ck.designs.to_numpy(),
                    ses.deploy(nets, 192, seed=4,
                               config=MultinetSearchConfig(
                                   seed=4)).designs.to_numpy()):
        np.testing.assert_array_equal(a, b)


def test_deploy_memo_counters_and_spans(tmp_path):
    nets = [get_cnn(c) for c in NETS]
    telemetry.disable()
    telemetry.reset()
    telemetry.enable(str(tmp_path))
    try:
        ses = Session(get_board(BOARD), device="cpu", max_cached_tables=2)
        cfg = MultinetSearchConfig(pop_size=32, seed=1)
        ses.deploy(nets, 32, config=cfg)
        ses.deploy(nets, 32, strategy="temporal", config=cfg)
        ses.deploy(nets, 32, strategy="random", chunk=32)
        st = ses.stats
        assert (st.deploy_calls, st.multi_table_builds,
                st.multi_table_hits) == (3, 1, 2)
        ses.deploy(nets, 32, strategy="random", chunk=32, weights=[1, 2])
        ses.deploy(nets, 32, strategy="random", chunk=32, slo_s=0.1)
        assert st.multi_table_builds == 3 and st.multi_table_evictions == 1
        assert ses.cache_stats()["multi_tables"]["size"] == 2
        assert ses.observability()["stats"]["deploy_calls"] == 5
        names = {ln["name"] for ln in telemetry.read_trace(
            telemetry.trace_path()) if ln["type"] == "span"}
        assert {"session.deploy", "session.multi_table_build"} <= names
        snap = telemetry.snapshot()
        assert snap["counters"]["multinet.generations"] >= 2
        # an explicit max_m keys its own tables
        mt = ses.multi_tables(nets, max_m=2)
        assert mt.max_m == 2 and len(mt.tables) == 2
    finally:
        telemetry.disable()
        telemetry.reset()


def test_deploy_kernel_fault_is_backend_fault(monkeypatch):
    """A fault in a lane's batch path leaves ``deploy`` as
    EvalError(BACKEND_FAULT) fed to the breaker; input errors pass as
    they are (ValueError, as in the JAX package)."""
    from repro_torch.core import batch_eval as be

    def fault(*args, **kwargs):
        raise RuntimeError("parallelism_search launch failed: CUDA error 700")

    nets = [get_cnn(c) for c in NETS]
    ses = Session(get_board(BOARD), device="cpu")
    monkeypatch.setattr(be, "parallelism_search", fault)
    for strategy in ("search", "random"):
        with pytest.raises(EvalError) as e:
            ses.deploy(nets, 32, strategy=strategy, chunk=32,
                       config=MultinetSearchConfig(pop_size=32))
        assert e.value.code == EvalError.BACKEND_FAULT
        assert isinstance(e.value.__cause__, RuntimeError)
    assert ses.breaker.trips == 0 and ses.stats.degraded == 0
    monkeypatch.undo()
    with pytest.raises(ValueError, match="n must be"):
        ses.deploy(nets, 0)
    with pytest.raises(ValueError, match="unknown strategy"):
        ses.deploy(nets, 8, strategy="grid")
    with pytest.raises(ValueError, match="slo"):
        ses.deploy(nets, 32, strategy="hybrid", config=MultinetSearchConfig(
            pop_size=32, objective="slo"))
    with pytest.raises(ValueError, match="unknown objective"):
        ses.deploy(nets, 32, config=MultinetSearchConfig(
            pop_size=32, objective="speed"))


def test_golden_multinet_deploy_matches_port_on_cpu():
    """The port on the CPU meets what chip_smoke.py's phase 14 (a) holds
    the card to on the golden ``Session.deploy`` arms: designs, shares and
    fronts exactly, the front rows' metrics within the gate."""
    golden = np.load(GOLDEN_MULTINET)
    d = MULTINET_DEPLOY
    ses = Session(get_board(d["board"]), device="cpu")
    for arm, c in d["arms"].items():
        extra = {k: v for k, v in c.items() if k != "nets"}
        res = _deploy(ses, get_cnn, c["nets"], arm, extra,
                      budget=d["budget"], pop=d["pop_size"],
                      cfg=MultinetSearchConfig)
        p = f"deploy/{arm}"
        for f, g in zip(DESIGN_FIELDS, res.designs.to_numpy()):
            np.testing.assert_array_equal(g, golden[f"{p}/{f}"],
                                          err_msg=f"{arm} {f}")
        for k, v in res.shares.items():
            np.testing.assert_array_equal(v, golden[f"{p}/shares/{k}"])
        np.testing.assert_array_equal(res.front, golden[f"{p}/front"])
        assert list(res.objectives) == json.loads(str(
            golden[f"{p}/objectives"]))
        for k, v in res.metrics.items():
            w = golden[f"{p}/front/{k}"]
            if k in EXACT:
                np.testing.assert_array_equal(v[res.front], w, err_msg=k)
            else:
                np.testing.assert_allclose(v[res.front], w, rtol=RTOL,
                                           err_msg=f"{arm} {k}")
