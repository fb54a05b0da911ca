"""The port's multinet joint cost model (``repro_torch.core.multinet``:
partition, joint_eval) and its per-row boards against the JAX package's,
on the CPU.

``joint_evaluate`` in all three modes meets ``repro``'s at M = 1–4 on
three boards: the discrete fields (the integer splits, the canonical
assignment, ``per_model_n_ces``) exactly, the rest within rtol 1e-5 (the
two batch paths part by an f32 ulp on some designs, and XLA contracts
the share arithmetic into fused multiply-adds).  Padded lanes are
returned as ``repro`` returns them.  The split repair equals ``repro``'s
bit for bit.  Within the port, the JAX package's reductions hold bit for
bit: M = 1 spatial is the single-model batch path, hybrid all-spatial is
spatial and hybrid all-shared is temporal; and ``evaluate_batch`` gives
the same bits on a 0-d board and on one board per row.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.cnn.registry import CNN_NAMES
from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core import batch_eval as jbe
from repro.core import multinet as jmn
from repro.core.dse import encoding as jenc
from repro.core.dse.samplers import sample_mixed as jax_sample_mixed
from repro.fpga.boards import BOARD_NAMES
from repro.fpga.boards import get_board as jax_get_board
from repro_torch.api import get_board, get_cnn
from repro_torch.core import batch_eval as tbe
from repro_torch.core import multinet as tmn
from repro_torch.core.dse import encoding as tenc
from repro_torch.fpga.archs import ARCH_NAMES, make_arch

from hypo_fallback import given, settings, st
from torch_golden import (DESIGN_FIELDS, GOLDEN_MULTINET, MULTINET_EVAL,
                          compute_golden_multinet, multinet_inputs,
                          multinet_mode_kw)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


RTOL = 1e-5
MAX_M = tmn.DEFAULT_MAX_M
B = 32
#: the discrete outputs, held exactly
EXACT = ("pes_split", "buf_split", "assign", "per_model_n_ces")
#: (model set, board) per M: three boards over the cases
CASES = {1: (("mobilenetv2",), "vcu108"),
         2: (("resnet50", "mobilenetv2"), "zc706"),
         3: (("resnet50", "mobilenetv2", "densenet121"), "zcu102"),
         4: (("vgg16", "resnet101", "xception", "mobilenetv2"), "vcu108")}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _deployments(names, seed, n=B):
    """Seeded designs, shares, time shares and assignment (host numpy,
    the JAX package's draws) for both packages."""
    rng = np.random.default_rng(seed)
    dbs = [jax_sample_mixed(rng, len(jax_get_cnn(c)), n) for c in names]
    md = jenc.stack_designs(dbs, MAX_M)
    m = len(names)
    sh = [jmn.sample_shares(rng, n, MAX_M, m) for _ in range(4)]
    assign = jenc.sample_assign(rng, n, MAX_M, m)
    return md, tenc.MultiDesignBatch.from_numpy(*md.to_numpy()), sh, assign


def _mode_kw(mode, sh, assign):
    if mode == "spatial":
        return dict(pes_shares=sh[0], buf_shares=sh[1], bw_shares=sh[2])
    if mode == "temporal":
        return dict(time_shares=sh[3], reconfig_s=0.002)
    return dict(assign=assign, pes_shares=sh[0], buf_shares=sh[1],
                bw_shares=sh[2], time_shares=sh[3], reconfig_s=0.002)


def _assert_joint(got: dict, want: dict, label: str) -> None:
    assert set(got) == set(want), (label, set(got) ^ set(want))
    for k, w in want.items():
        g, w = _np(got[k]), np.asarray(w)
        assert g.shape == w.shape, (label, k, g.shape, w.shape)
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL,
                                       err_msg=f"{label} {k}")


# --------------------------------------------------------------------------
# joint_evaluate against the JAX package
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["spatial", "temporal", "hybrid"])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_joint_evaluate_equal_jax(m, mode):
    """Every output of every mode, the padded lanes' planes included."""
    names, board = CASES[m]
    jmd, tmd, sh, assign = _deployments(names, seed=10 * m)
    slo = [0.05] * m
    jmt = jmn.make_multi_tables([jax_get_cnn(c) for c in names], slo_s=slo)
    tmt = tmn.make_multi_tables([get_cnn(c) for c in names], slo_s=slo,
                                device="cpu")
    kw = _mode_kw(mode, sh, assign)
    want = jmn.joint_evaluate(jmd, jmt, jax_get_board(board), mode=mode,
                              **kw)
    got = tmn.joint_evaluate(tmd, tmt, get_board(board), mode=mode, **kw)
    _assert_joint(got, want, f"M={m} {mode}")
    assert all(v.device.type == "cpu" for v in got.values())


def test_padded_lanes_equal_jax_and_temporal_copies_are_exact():
    """Padded lanes: in the spatial mode the last model's design on the
    FULL board (evaluated), in the temporal mode a copy of the last real
    lane; both equal ``repro``'s, and the copy equals the batch path run
    on that lane's design and the full board bit for bit."""
    names, board = CASES[2]
    jmd, tmd, sh, assign = _deployments(names, seed=5)
    jmt = jmn.make_multi_tables([jax_get_cnn(c) for c in names])
    tmt = tmn.make_multi_tables([get_cnn(c) for c in names], device="cpu")
    for mode in ("spatial", "temporal"):
        kw = _mode_kw(mode, sh, assign)
        want = jmn.joint_evaluate(jmd, jmt, jax_get_board(board), mode=mode,
                                  **kw)
        got = tmn.joint_evaluate(tmd, tmt, get_board(board), mode=mode, **kw)
        for k in tmn.joint_eval.PER_MODEL_KEYS:
            g, w = _np(got[f"per_model_{k}"]), np.asarray(
                want[f"per_model_{k}"])
            if k == "n_ces":
                np.testing.assert_array_equal(g[:, 2:], w[:, 2:])
            else:
                np.testing.assert_allclose(g[:, 2:], w[:, 2:], rtol=RTOL,
                                           err_msg=f"{mode} {k}")
            # every padded lane is the same evaluation
            np.testing.assert_array_equal(g[:, 2], g[:, 3])
    # the temporal copy is the batch path on lane 1's design, full board
    out = tmn.joint_evaluate(tmd, tmt, get_board(board), mode="temporal",
                             time_shares=sh[3])
    full = tbe.evaluate_batch(tmd.model(1), tmt.tables[1], get_board(board))
    for k in tmn.joint_eval.PER_MODEL_KEYS:
        if k in ("latency_s", "throughput_ips"):
            continue        # round-robin adjusted on the real lanes only
        np.testing.assert_array_equal(
            _np(out[f"per_model_{k}"])[:, 1], _np(full[k]), err_msg=k)
        np.testing.assert_array_equal(
            _np(out[f"per_model_{k}"])[:, 2], _np(full[k]), err_msg=k)
    # a padded lane keeps the full board's raw latency; its time share is
    # 0, so its throughput is 0
    np.testing.assert_array_equal(_np(out["per_model_latency_s"])[:, 3],
                                  _np(full["latency_s"]))
    assert (_np(out["per_model_throughput_ips"])[:, 3] == 0).all()
    # a padded lane whose plane differs from the last real lane's is
    # evaluated, not copied
    md2 = tenc.MultiDesignBatch(tmd.seg_end.clone(), tmd.seg_pipe.clone(),
                                tmd.seg_nce.clone(),
                                tmd.inter_pipe.clone())
    md2.inter_pipe[:, 3] = ~md2.inter_pipe[:, 3]
    out2 = tmn.joint_evaluate(md2, tmt, get_board(board), mode="temporal",
                              time_shares=sh[3])
    lone = tbe.evaluate_batch(md2.model(3), tmt.tables[3], get_board(board))
    np.testing.assert_array_equal(_np(out2["per_model_latency_s"])[:, 3],
                                  _np(lone["latency_s"]))


# --------------------------------------------------------------------------
# partition: repair, slices and host helpers against the JAX package
# --------------------------------------------------------------------------
@settings(max_examples=40, deadline=None)
@given(m=st.integers(1, MAX_M), board=st.sampled_from(BOARD_NAMES),
       seed=st.integers(0, 10_000))
def test_repair_equal_jax_and_valid(m, board, seed):
    """``repair_partition_torch`` and ``repair_time_shares_torch`` equal
    ``repair_partition_jax`` and ``repair_time_shares_jax`` exactly, on
    arbitrary raw shares (degenerate ones included), and every repaired
    split passes ``validate_partition``."""
    rng = np.random.default_rng(seed)
    mv = np.zeros(MAX_M, np.float32)
    mv[:m] = 1.0
    raw = [rng.gamma(0.3, 1.0, size=(16, MAX_M)).astype(np.float32)
           for _ in range(4)]
    raw[0][0] = 0.0                      # all-zero row -> equal fallback
    raw[1][1, :1] = 1e9                  # extreme skew
    want = jmn.repair_partition_jax(*raw[:3],
                                    jbe.make_device_tables(
                                        jax_get_board(board)), mv)
    got = tmn.repair_partition_torch(
        *(torch.from_numpy(r) for r in raw[:3]),
        tbe.make_device_tables(get_board(board), device="cpu"),
        torch.from_numpy(mv))
    for k in ("pes", "buf", "bw"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert tmn.validate_partition(got, get_board(board), mv).all()
    for floor in (0.05, 0.3):
        np.testing.assert_array_equal(
            _np(tmn.repair_time_shares_torch(torch.from_numpy(raw[3]), mv,
                                             floor=floor)),
            np.asarray(jmn.repair_time_shares_jax(raw[3], mv, floor=floor)))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_slice_helpers_equal_jax(m):
    """``slice_masks``, ``slice_shares``, ``gather_slices`` and
    ``partition_devices`` on a hybrid batch (all-spatial, all-shared and
    mixed rows) equal the JAX package's."""
    rng = np.random.default_rng(m)
    n = 24
    assign = jenc.sample_assign(rng, n, MAX_M, m)
    assign[:4] = 0.0
    assign[4:8, :m] = 1.0
    mv = np.zeros(MAX_M, np.float32)
    mv[:m] = 1.0
    raw = jmn.sample_shares(rng, n, MAX_M, m)
    jm = jmn.slice_masks(assign, mv)
    tm = tmn.slice_masks(torch.from_numpy(assign), torch.from_numpy(mv))
    for g, w in zip(tm, jm):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_array_equal(
        _np(tmn.slice_shares(torch.from_numpy(raw), tm[0], tm[1])),
        np.asarray(jmn.slice_shares(raw, jm[0], jm[1])))
    dev = get_board("zc706")
    jpart = jmn.repair_partition_jax(raw, raw, raw, jbe.make_device_tables(
        jax_get_board("zc706")), jm[1])
    tpart = tmn.repair_partition_torch(
        *(torch.from_numpy(raw),) * 3,
        tbe.make_device_tables(dev, device="cpu"), tm[1])
    jg = jmn.gather_slices(jpart, jm[2])
    tg = tmn.gather_slices(tpart, tm[2])
    for k in ("pes", "buf", "bw"):
        np.testing.assert_array_equal(_np(getattr(tg, k)),
                                      np.asarray(getattr(jg, k)))
    jd = jmn.partition_devices(jbe.make_device_tables(
        jax_get_board("zc706")), jg, mv)
    td = tmn.partition_devices(tbe.make_device_tables(dev, device="cpu"),
                               tg, torch.from_numpy(mv))
    for k in tbe.DEVICE_TABLE_FIELDS:
        np.testing.assert_array_equal(_np(getattr(td, k)),
                                      np.asarray(getattr(jd, k)), err_msg=k)


def test_host_helpers_equal_jax():
    """The draws and padding helpers equal the JAX package's, RNG state
    after each draw included."""
    for m in (1, 3):
        r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
        np.testing.assert_array_equal(tmn.sample_shares(r1, 9, MAX_M, m),
                                      jmn.sample_shares(r2, 9, MAX_M, m))
        np.testing.assert_array_equal(
            tenc.sample_assign(r1, 9, MAX_M, m, p_shared=0.35),
            jenc.sample_assign(r2, 9, MAX_M, m, p_shared=0.35))
        assert r1.random() == r2.random()
        np.testing.assert_array_equal(tmn.equal_shares(5, MAX_M, m),
                                      jmn.equal_shares(5, MAX_M, m))
    jmd, tmd, sh, _ = _deployments(("resnet50", "mobilenetv2"), 1, n=5)
    for g, w in zip(tenc.pad_deployments(tmd, 9).to_numpy(),
                    jenc.pad_deployments(jmd, 9).to_numpy()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        _np(tenc.pad_plane(torch.from_numpy(sh[0]), 9)),
        np.asarray(jenc.pad_plane(sh[0], 9)))
    assert tenc.pad_deployments(tmd, 3) is tmd
    assert tmd.model(1).batch == 5 and tmd.n_models == MAX_M
    with pytest.raises(ValueError, match="exceed"):
        tenc.stack_designs([tmd.model(0)] * 5, MAX_M)
    with pytest.raises(ValueError, match="batch size"):
        tenc.stack_designs([tmd.model(0), tmd.model(1).take(slice(0, 2))])


def test_shared_max_l_equal_jax():
    for counts in ([], [53], [53, 52], [53, 170], [161, 300, 2]):
        assert tbe.shared_max_L(counts) == jbe.shared_max_L(counts)
    mt = tmn.make_multi_tables([get_cnn("resnet152"), get_cnn("mobilenetv2")],
                               device="cpu")
    assert [t.max_L for t in mt.tables] == [160] * MAX_M


# --------------------------------------------------------------------------
# reductions within the port, bit for bit
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cnn", CNN_NAMES)
def test_m1_spatial_and_hybrid_equal_single_model(cnn):
    """A one-model spatial deployment, and a one-model hybrid deployment
    with a dedicated slice, reproduce the port's single-model batch path
    bit for bit on the 3 archs × {2, 9} CEs of VCU108."""
    net, dev = get_cnn(cnn), get_board("vcu108")
    specs = [make_arch(a, net, n) for a in ARCH_NAMES for n in (2, 9)]
    db = tenc.encode_specs(specs, len(net))
    single = tbe.evaluate_batch(db, tbe.make_tables(net, device="cpu"), dev)
    mt = tmn.make_multi_tables([net], device="cpu")
    md = tenc.stack_designs([db], MAX_M)
    for mode in ("spatial", "hybrid"):
        out = tmn.joint_evaluate(md, mt, dev, mode=mode)
        for k in tmn.joint_eval.PER_MODEL_KEYS:
            np.testing.assert_array_equal(
                _np(single[k]), _np(out[f"per_model_{k}"])[:, 0],
                err_msg=f"{cnn} {mode} {k}")
        np.testing.assert_array_equal(_np(out["worst_latency_s"]),
                                      _np(single["latency_s"]))
        np.testing.assert_array_equal(_np(out["agg_throughput_ips"]),
                                      _np(single["throughput_ips"]))


def _hybrid_fixture(seed):
    names = ("resnet50", "mobilenetv2")
    _, md, sh, _ = _deployments(names, seed, n=12)
    mt = tmn.make_multi_tables([get_cnn(c) for c in names],
                               slo_s=[0.05, 0.01], device="cpu")
    return md, mt, sh, get_board("zc706")


def test_hybrid_all_spatial_is_spatial():
    md, mt, sh, dev = _hybrid_fixture(0)
    out_s = tmn.joint_evaluate(md, mt, dev, pes_shares=sh[0],
                               buf_shares=sh[1], bw_shares=sh[2])
    out_h = tmn.joint_evaluate(
        md, mt, dev, mode="hybrid",
        assign=np.zeros((md.batch, MAX_M), np.float32), pes_shares=sh[0],
        buf_shares=sh[1], bw_shares=sh[2], time_shares=sh[3])
    for k in out_s:
        np.testing.assert_array_equal(_np(out_s[k]), _np(out_h[k]),
                                      err_msg=k)
    assert (_np(out_h["assign"]) == 0).all()
    assert (_np(out_h["round_period_s"]) == 0).all()


def test_hybrid_all_shared_is_temporal():
    md, mt, sh, dev = _hybrid_fixture(2)
    assign = np.zeros((md.batch, MAX_M), np.float32)
    assign[:, :2] = 1.0
    out_t = tmn.joint_evaluate(md, mt, dev, mode="temporal",
                               time_shares=sh[3], reconfig_s=0.004)
    out_h = tmn.joint_evaluate(md, mt, dev, mode="hybrid", assign=assign,
                               pes_shares=sh[0], buf_shares=sh[1],
                               bw_shares=sh[2], time_shares=sh[3],
                               reconfig_s=0.004)
    for k in out_t:
        a, b = _np(out_t[k]), _np(out_h[k])
        if a.ndim == 2:     # per-model planes: padded columns differ
            a, b = a[:, :2], b[:, :2]
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (_np(out_h["pes_split"])[:, :2] == np.float32(dev.pes)).all()


def test_hybrid_mixed_charges_only_shared_models():
    md, mt, sh, dev = _hybrid_fixture(5)
    assign = np.zeros((md.batch, MAX_M), np.float32)
    assign[:, 1] = 1.0
    out = tmn.joint_evaluate(md, mt, dev, mode="hybrid", assign=assign,
                             pes_shares=sh[0], buf_shares=sh[1],
                             bw_shares=sh[2], time_shares=sh[3])
    out_s = tmn.joint_evaluate(md, mt, dev, pes_shares=sh[0],
                               buf_shares=sh[1], bw_shares=sh[2])
    np.testing.assert_array_equal(_np(out["pes_split"]),
                                  _np(out_s["pes_split"]))
    for k in ("per_model_latency_s", "per_model_throughput_ips"):
        np.testing.assert_array_equal(_np(out[k])[:, 0], _np(out_s[k])[:, 0])
    assert (_np(out["per_model_latency_s"])[:, 1]
            > _np(out_s["per_model_latency_s"])[:, 1]).all()
    assert (_np(out["per_model_throughput_ips"])[:, 1]
            < _np(out_s["per_model_throughput_ips"])[:, 1]).all()


# --------------------------------------------------------------------------
# per-row boards in the batch path
# --------------------------------------------------------------------------
def test_per_row_boards_equal_zero_d_board():
    """``evaluate_batch`` on one board per row gives the bits of the 0-d
    board when every row holds that board, and each row's own 0-d result
    when the rows differ (slices of other budgets and bandwidths)."""
    net, dev = get_cnn("resnet50"), get_board("zcu102")
    t = tbe.make_tables(net, device="cpu")
    db = tenc.DesignBatch.from_numpy(*jax_sample_mixed(
        np.random.default_rng(3), len(net), 40).to_numpy())
    d0 = tbe.make_device_tables(dev, device="cpu")
    rows = tbe.DeviceTables(*(getattr(d0, k).expand(40).contiguous()
                              for k in tbe.DEVICE_TABLE_FIELDS))
    assert rows.per_row and not d0.per_row
    want = tbe.evaluate_batch(db, t, d0, tile=16)
    got = tbe.evaluate_batch(db, t, rows, tile=16, full_pes=dev.pes)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    # different boards per row: row i equals its own board alone
    frac = torch.linspace(0.05, 1.0, 40)
    sliced = tbe.DeviceTables(
        pes=torch.floor(d0.pes * frac), on_chip_bytes=torch.floor(
            d0.on_chip_bytes * frac.flip(0)), bpc=d0.bpc * frac,
        bps=d0.bps * frac, clock_hz=rows.clock_hz,
        wordbytes=rows.wordbytes)
    got = tbe.evaluate_batch(db, t, sliced, tile=16, full_pes=dev.pes)
    for i in (0, 17, 39):
        one = sliced.take(slice(i, i + 1))
        alone = tbe.evaluate_batch(
            db.take(slice(i, i + 1)), t,
            tbe.DeviceTables(*(getattr(one, k)[0]
                               for k in tbe.DEVICE_TABLE_FIELDS)),
            tile=16, full_pes=dev.pes)
        for k in alone:
            np.testing.assert_array_equal(_np(got[k])[i:i + 1],
                                          _np(alone[k]), err_msg=(i, k))
    with pytest.raises(ValueError, match="full_pes"):
        tbe.evaluate_batch(db, t, rows)
    with pytest.raises(ValueError, match="board rows"):
        tbe.evaluate_batch(db.take(slice(0, 8)), t, rows, full_pes=dev.pes)
    assert rows.col("pes").shape == (40, 1) and d0.col("pes").dim() == 0


# --------------------------------------------------------------------------
# tables, SLO grading, errors
# --------------------------------------------------------------------------
def test_make_multi_tables_errors_and_broadcast():
    nets = [get_cnn("resnet50"), get_cnn("mobilenetv2")]
    mk = lambda **kw: tmn.make_multi_tables(nets, device="cpu", **kw)
    with pytest.raises(ValueError, match="non-negative"):
        mk(weights=[1.0, -2.0])
    with pytest.raises(ValueError, match="all zero"):
        mk(weights=[0.0, 0.0])
    with pytest.raises(ValueError, match="finite"):
        mk(weights=[np.inf, 1.0])
    with pytest.raises(ValueError, match="weights must be a scalar"):
        mk(weights=[1.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="slo_s must be a scalar"):
        mk(slo_s=[0.1])
    with pytest.raises(ValueError, match="positive"):
        mk(slo_s=[-0.1, 0.1])
    with pytest.raises(ValueError, match="positive"):
        mk(slo_s=[np.nan, 0.1])
    with pytest.raises(ValueError, match="exceed max_m"):
        tmn.make_multi_tables(nets * 3, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        tmn.make_multi_tables([], device="cpu")
    mt = mk(weights=5.0, slo_s=0.25)
    np.testing.assert_allclose(mt.normalized_weights, [0.5, 0.5])
    assert _np(mt.slo_s)[:2].tolist() == [0.25, 0.25]
    assert mt.n_models == 2 and mt.max_m == MAX_M and mt.n_layers(1) == 52
    jmt = jmn.make_multi_tables([jax_get_cnn("resnet50"),
                                 jax_get_cnn("mobilenetv2")],
                                weights=[1.0, 3.0], slo_s=[0.1, np.inf])
    tmt = mk(weights=[1.0, 3.0], slo_s=[0.1, np.inf])
    for k in ("model_valid", "weights", "slo_s"):
        np.testing.assert_array_equal(_np(getattr(tmt, k)),
                                      np.asarray(getattr(jmt, k)))
    # a zero-weight model is excluded from the weighted-rate metrics
    _, md, _, _ = _deployments(("resnet50", "mobilenetv2"), 0, n=4)
    out = tmn.joint_evaluate(md, mk(weights=[1.0, 0.0]), get_board("zc706"))
    assert np.isfinite(_np(out["fairness"])).all()
    assert np.isfinite(_np(out["min_model_throughput_ips"])).all()


def test_joint_evaluate_errors():
    _, md, _, _ = _deployments(("resnet50", "mobilenetv2"), 0, n=4)
    mt = tmn.make_multi_tables([get_cnn("resnet50"), get_cnn("mobilenetv2")],
                               device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        tmn.joint_evaluate(md, mt, get_board("zc706"), mode="mixed")
    # an unsharded mesh object takes the single-device path, bit for bit
    plain = tmn.joint_evaluate(md, mt, get_board("zc706"))
    meshed = tmn.joint_evaluate(md, mt, get_board("zc706"), mesh=object())
    assert set(meshed) == set(plain)
    for k, v in plain.items():
        assert torch.equal(meshed[k], v), k
    mt3 = tmn.make_multi_tables([get_cnn("resnet50")], max_m=3,
                                device="cpu")
    with pytest.raises(ValueError, match="design lanes"):
        tmn.joint_evaluate(md, mt3, get_board("zc706"))


def test_slo_attainment_dist_equal_jax_and_graded():
    names = ("resnet50", "mobilenetv2")
    jmt = jmn.make_multi_tables([jax_get_cnn(c) for c in names],
                                slo_s=[0.010, 0.010], weights=[3.0, 1.0])
    tmt = tmn.make_multi_tables([get_cnn(c) for c in names],
                                slo_s=[0.010, 0.010], weights=[3.0, 1.0],
                                device="cpu")
    lat = np.array([[1e9, 1e9], [1e-6, 1e9], [1e-6, 1e-6], [0.009, 1e9]],
                   np.float32)
    att = tmn.slo_attainment_dist(lat, tmt)
    np.testing.assert_array_equal(att, jmn.slo_attainment_dist(lat, jmt))
    np.testing.assert_array_equal(
        tmn.slo_attainment_dist(torch.from_numpy(lat), tmt), att)
    assert att[0] == 0.0 and att[2] == 1.0
    np.testing.assert_allclose(att[1], 0.75)
    assert 0.0 < att[3] < 0.75
    grid = np.linspace(1e-4, 0.05, 32, dtype=np.float32)
    a = tmn.slo_attainment_dist(np.stack([grid, grid], 1), tmt)
    assert (np.diff(a) <= 1e-12).all()
    free = tmn.make_multi_tables([get_cnn(c) for c in names], device="cpu")
    np.testing.assert_allclose(tmn.slo_attainment_dist(lat, free), 1.0)
    with pytest.raises(ValueError, match="covers 1 models"):
        tmn.slo_attainment_dist(lat[:, :1], tmt)


# --------------------------------------------------------------------------
# the golden file chip_smoke.py holds the card to
# --------------------------------------------------------------------------
def test_golden_multinet_is_current():
    """The committed golden_multinet.npz still equals what the JAX
    package computes: inputs, designs, shares, fronts and the discrete
    outputs exact, the other metrics within rtol 1e-6."""
    want = compute_golden_multinet()
    got = np.load(GOLDEN_MULTINET)
    assert sorted(got.files) == sorted(want)
    for k, w in want.items():
        if w.dtype.kind == "f" and "/in/" not in k \
                and "/shares/" not in k and not k.endswith(EXACT):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_golden_multinet_eval_matches_port_on_cpu():
    """The port on the CPU meets what chip_smoke.py's phase 14 (a) holds
    the card to on the golden ``joint_evaluate`` rows, from inputs drawn
    by the port's own samplers."""
    from repro_torch.core.dse.samplers import sample_mixed
    golden = np.load(GOLDEN_MULTINET)
    for mode, c in MULTINET_EVAL.items():
        md, planes = multinet_inputs(mode, sample_mixed, tenc.stack_designs,
                                     tmn.sample_shares, tenc.sample_assign,
                                     get_cnn)
        for k, v in zip(DESIGN_FIELDS, md.to_numpy()):
            np.testing.assert_array_equal(v, golden[f"eval/{mode}/in/{k}"])
        for k, v in planes.items():
            np.testing.assert_array_equal(v, golden[f"eval/{mode}/in/{k}"])
        mt = tmn.make_multi_tables([get_cnn(n) for n in c["nets"]],
                                   weights=c["weights"], slo_s=c["slo_s"],
                                   device="cpu")
        got = tmn.joint_evaluate(md, mt, get_board(c["board"]), mode=mode,
                                 **multinet_mode_kw(mode, planes))
        _assert_joint(got, {k.rsplit("/", 1)[1]: golden[k]
                            for k in golden.files
                            if k.startswith(f"eval/{mode}/out/")}, mode)
