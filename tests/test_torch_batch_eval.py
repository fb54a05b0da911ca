"""The port's batch path (``repro_torch.core.batch_eval``) against the JAX
package's, on the CPU.

Tables must be equal bit for bit; the largest-remainder PE split, the
segmented max-scan and the PE split's MAC sums exactly equal; and the whole
slice on every CNN x board must give the same ``n_ces`` and metrics within
rtol 1e-5 (the JAX package's own scalar-vs-batch tolerances,
``tests/test_batch_eval.py:15``, are looser: 1e-4 and 0.04).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.registry import CNN_NAMES
from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core import batch_eval as jbe
from repro.core.dse import sample_mixed as jax_sample_mixed
from repro.fpga.archs import ARCH_NAMES, make_arch
from repro.fpga.boards import BOARD_NAMES
from repro.fpga.boards import get_board as jax_get_board
from repro_torch.cnn.registry import get_cnn
from repro_torch.core import batch_eval as tbe
from repro_torch.core.dse.encoding import DesignBatch
from repro_torch.fpga.boards import get_board
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


RTOL = 1e-5


def _db(jax_db) -> DesignBatch:
    return DesignBatch.from_numpy(*jax_db.to_numpy())


def _assert_metrics(got: dict, want: dict, label: str) -> None:
    assert set(got) == set(want), label
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(w)
        if k == "n_ces":
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL,
                                       err_msg=f"{label} {k}")


@pytest.mark.parametrize("cnn", CNN_NAMES)
def test_make_tables_equal_jax(cnn):
    want = jbe.make_tables(jax_get_cnn(cnn))
    got = tbe.make_tables(get_cnn(cnn), device="cpu")
    assert got.L == int(want.L) and got.candidates == want.candidates
    fed = tbe.net_tables_from_numpy(
        {k: np.asarray(getattr(want, k)) for k in ("L",)
         + tbe.NET_TABLE_FIELDS}, want.candidates, device="cpu")
    for k in tbe.NET_TABLE_FIELDS:
        w = np.asarray(getattr(want, k))
        for t in (got, fed):
            g = getattr(t, k)
            assert g.dtype == torch.float32, k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


@pytest.mark.parametrize("board", BOARD_NAMES)
def test_make_device_tables_equal_jax(board):
    want = jbe.make_device_tables(jax_get_board(board))
    got = tbe.make_device_tables(get_board(board), device="cpu")
    fed = tbe.device_tables_from_numpy(
        {k: np.asarray(getattr(want, k)) for k in tbe.DEVICE_TABLE_FIELDS},
        device="cpu")
    for k in tbe.DEVICE_TABLE_FIELDS:
        for t in (got, fed):
            assert getattr(t, k).dtype == torch.float32, k
            assert getattr(t, k).item() == float(getattr(want, k)), k


@pytest.mark.parametrize("seed", range(4))
def test_largest_remainder_equal_jax(seed):
    """Seeded shares with many ties (small integer MACs, repeated values)
    and large ones (f32 rounding), random CE masks and totals."""
    rng = np.random.default_rng(seed)
    B = 512
    small = rng.integers(0, 4, (B, 16)).astype(np.float32)
    big = (rng.integers(1, 2 ** 12, (B, 16))
           * rng.integers(1, 2 ** 14, (B, 16))).astype(np.float32)
    shares = np.where(rng.random((B, 1)) < 0.5, small, big)
    valid = rng.random((B, 16)) < rng.uniform(0.1, 1.0, (B, 1))
    shares = np.where(valid, shares, 0.0).astype(np.float32)
    for total in (4.0, 768.0, 900.0, 2520.0):
        want = np.asarray(jbe._largest_remainder(
            jnp.asarray(shares), jnp.float32(total), jnp.asarray(valid)))
        got = tbe._largest_remainder(torch.from_numpy(shares),
                                     torch.tensor(total),
                                     torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reverse", [False, True])
def test_seg_scan_max_equal_jax(reverse):
    rng = np.random.default_rng(3)
    for L in (1, 7, 53, 160):
        vals = rng.integers(0, 6, (64, L)).astype(np.float32)   # ties
        flags = rng.random((64, L)) < 0.3
        want = np.asarray(jbe.seg_scan_max(jnp.asarray(vals),
                                           jnp.asarray(flags), reverse))
        got = tbe.seg_scan_max(torch.from_numpy(vals),
                               torch.from_numpy(flags), reverse)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L", [160, 192, 288])
def test_pe_split_mac_sums_equal_jax(L):
    """The per-CE MAC sums that feed the PE split round as the reference's
    contraction does, for the layer paddings the tables use (multiples of
    32), including CE ids past NC (zero rows)."""
    rng = np.random.default_rng(L)
    macs = (rng.integers(1, 2 ** 20, L)
            * rng.integers(1, 2 ** 10, L)).astype(np.float32)
    ce = rng.integers(0, 18, (256, L))
    oh = (ce[..., None] == np.arange(16)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: jnp.einsum("l,blc->bc", a, b))(
        jnp.asarray(macs), jnp.asarray(oh)))
    got = tbe._dot_sum(torch.from_numpy(macs)[None, :, None]
                       * torch.from_numpy(oh))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cnn", CNN_NAMES)
def test_slice_matches_jax_on_every_board(cnn):
    """The full slice: templates (3 archs x n in {2, 5, 9, 11}) and 64
    sample_mixed rows, on all 4 boards."""
    jnet = jax_get_cnn(cnn)
    jt = jbe.make_tables(jnet)
    tt = tbe.make_tables(get_cnn(cnn), device="cpu")
    tmpl = jbe.encode_specs([make_arch(a, jnet, n) for a in ARCH_NAMES
                             for n in (2, 5, 9, 11)], len(jnet))
    mixed = jax_sample_mixed(np.random.default_rng(5), len(jnet), 64)
    for board in BOARD_NAMES:
        for label, db in (("templates", tmpl), ("mixed", mixed)):
            want = jbe.evaluate_batch(db, jt, jax_get_board(board),
                                      backend="ref")
            got = tbe.evaluate_batch(_db(db), tt, get_board(board))
            _assert_metrics(got, want, f"{cnn}/{board}/{label}")


def test_densenet264_matches_jax_at_288_rows(monkeypatch):
    """DenseNet-264 (264 layers, padded to 288 rows): the JAX package's own
    DenseNet generator at its blocks gives the layer specs, and the port's
    tables and whole slice equal the JAX package's on every board."""
    import repro.cnn.densenet as jax_densenet
    monkeypatch.setattr(jax_densenet, "_BLOCKS", (6, 12, 64, 48))
    jnet, _ = jax_densenet.densenet121()
    net = get_cnn("densenet264")
    assert len(jnet) == len(net) == 264
    jt = jbe.make_tables(jnet)
    tt = tbe.make_tables(net, device="cpu")
    assert tt.max_L == jt.F.shape[0] == 288
    for k in tbe.NET_TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    tmpl = jbe.encode_specs([make_arch(a, jnet, n) for a in ARCH_NAMES
                             for n in (2, 5, 9, 11)], len(jnet))
    mixed = jax_sample_mixed(np.random.default_rng(7), len(jnet), 64)
    for board in BOARD_NAMES:
        for label, db in (("templates", tmpl), ("mixed", mixed)):
            want = jbe.evaluate_batch(db, jt, jax_get_board(board),
                                      backend="ref")
            got = tbe.evaluate_batch(_db(db), tt, get_board(board))
            _assert_metrics(got, want, f"densenet264/{board}/{label}")


def test_blocks_change_no_number():
    """Evaluating in CPU tiles of 8 or in one block gives the same bits."""
    net = get_cnn("xception")
    tt = tbe.make_tables(net, device="cpu")
    db = _db(jax_sample_mixed(np.random.default_rng(2), len(net), 37))
    one = tbe.evaluate_batch(db, tt, get_board("zc706"), tile=64)
    tiled = tbe.evaluate_batch(db, tt, get_board("zc706"), tile=8)
    for k in one:
        np.testing.assert_array_equal(one[k].numpy(), tiled[k].numpy(),
                                      err_msg=k)


def test_spec_list_tail_padding_exact():
    """Chunked spec evaluation with a ragged tail equals unchunked
    evaluation: padded rows are sliced off, not leaked."""
    from repro_torch.core.dse import decode_design, sample_mixed
    net = get_cnn("mobilenetv2")
    db = sample_mixed(np.random.default_rng(13), len(net), 37)
    specs = [decode_design(db, i, len(net)) for i in range(37)]
    dev = get_board("zc706")
    whole = tbe._evaluate_specs(specs, net, dev, chunk=2048, device="cpu")
    ragged = tbe._evaluate_specs(specs, net, dev, chunk=16, device="cpu")
    for k in whole:
        np.testing.assert_array_equal(whole[k], ragged[k], err_msg=k)
        assert len(ragged[k]) == 37


def test_overflowing_rows_match_jax():
    """Non-canonical rows whose CE count passes NC = 16: layers of the
    CEs past 16 get a zero one-hot row in both packages (an out-of-range
    one-hot index gives zeros, not an error), and the metrics agree,
    NaN for NaN."""
    jnet = jax_get_cnn("resnet50")
    db = jax_sample_mixed(np.random.default_rng(9), len(jnet), 24)
    seg_end, seg_pipe, seg_nce, inter = (np.array(a) for a in db.to_numpy())
    seg_nce[:, 0] = 12 + np.arange(24) % 9          # 12..20 CEs up front
    seg_pipe[:, 0] = True
    jdb = jbe.DesignBatch.from_numpy(seg_end, seg_pipe, seg_nce, inter)
    for board in ("zc706", "zcu102"):
        want = jbe.evaluate_batch(jdb, jbe.make_tables(jnet),
                                  jax_get_board(board), backend="ref")
        got = tbe.evaluate_batch(
            DesignBatch.from_numpy(seg_end, seg_pipe, seg_nce, inter),
            tbe.make_tables(get_cnn("resnet50"), device="cpu"),
            get_board(board))
        assert (np.asarray(want["n_ces"]) == 16).any()
        _assert_metrics(got, want, f"overflow/{board}")
