"""The port on the card: each CUDA kernel (the parallelism search, the Eq. 1
latency sweep, the CE convolution) against its plain PyTorch version, and
the Session's main path through the search kernel.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when
no card is visible (the decision is made in the fixture, never at import).
On a machine with an H100, ``nvcc`` and no JAX:

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.api import Session, get_board, get_cnn
from repro_torch.cnn.registry import CNN_NAMES
from repro_torch.core.batch_eval import (_ce_maps, _pair_layer_tables,
                                         _search_ce, make_device_tables,
                                         make_tables, pes_hint)
from repro_torch.core.dse import encode_specs, sample_mixed
from repro_torch.fpga.archs import ARCH_NAMES, make_arch
from repro_torch.fpga.boards import BOARD_NAMES
from repro_torch.kernels.conv_ce import conv_ce, conv_ref, grid_size
from repro_torch.kernels.mccm_eval import (launches, mccm_latency,
                                           mccm_latency_ref, pair_tables,
                                           parallelism_search,
                                           parallelism_search_ref,
                                           reset_launches)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a visible CUDA card (and nvcc for the kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _inputs(net, board, db, device):
    t = make_tables(net, device=device)
    m = _ce_maps(db.to(device), t, make_device_tables(board, device=device))
    pairs = pair_tables(t.candidates, pes_hint(board.pes))
    return (m.pes_ce, _search_ce(m), *_pair_layer_tables(t, pairs))


def _assert_kernel_equals_plain(args, label):
    ker = parallelism_search(*args)
    ref = parallelism_search_ref(*args)
    torch.cuda.synchronize()
    for name, k, r in zip(("pf", "ph", "pw"), ker[:3], ref[:3]):
        assert torch.equal(k, r), f"{label} {name}"
    k, r = ker[3].cpu().numpy(), ref[3].cpu().numpy()
    np.testing.assert_array_equal(np.isinf(k), np.isinf(r))
    fin = np.isfinite(r)
    np.testing.assert_allclose(k[fin], r[fin], rtol=1e-6, err_msg=label)


@pytest.mark.parametrize("cnn", CNN_NAMES)
def test_kernel_equals_plain_on_card(cuda, cnn):
    net = get_cnn(cnn)
    tmpl = encode_specs([make_arch(a, net, n) for a in ARCH_NAMES
                         for n in (2, 5, 9, 11)], len(net))
    mixed = sample_mixed(np.random.default_rng(2), len(net), 512)
    for board in BOARD_NAMES:
        for label, db in (("templates", tmpl), ("mixed", mixed)):
            _assert_kernel_equals_plain(
                _inputs(net, get_board(board), db, cuda),
                f"{cnn}/{board}/{label}")


def test_kernel_infeasible_ces_on_card(cuda):
    net = get_cnn("mobilenetv2")
    args = list(_inputs(net, get_board("zc706"), encode_specs(
        [make_arch("hybrid", net, 2)], len(net)), cuda))
    L = args[1].shape[1]
    args[0] = torch.zeros(5, 16, device=cuda)
    args[1] = torch.full((5, L), -1, dtype=torch.int32, device=cuda)
    pf, ph, pw, cost = parallelism_search(*args)
    assert bool((pf == 1).all() & (ph == 1).all() & (pw == 1).all())
    assert bool(torch.isinf(cost).all())


def test_session_on_card_goes_through_kernel(cuda):
    net, board = get_cnn("resnet50"), get_board("zcu102")
    db = sample_mixed(np.random.default_rng(0), len(net), 3000)
    reset_launches()
    got = Session(board, device=str(cuda), chunk=1024).evaluate(db, net)
    assert launches()["parallelism_search"] == 3    # one per chunk
    want = Session(board, device="cpu").evaluate(db, net)
    for k, w in want.items():
        assert got[k].device.type == "cuda"
        g = got[k].cpu()
        if k == "n_ces":
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       err_msg=k)


def test_mccm_latency_kernel_equals_plain_on_card(cuda):
    """Per-layer ⟨pf, ph, pw⟩ as the batch path chooses them for 3000
    ResNet-50 designs: the kernel equals its plain version and the batch
    path's own cycles bit for bit; plus a ragged batch of random ones."""
    from repro_torch.core.batch_eval import _per_layer, layer_state
    net, board = get_cnn("resnet50"), get_board("zcu102")
    t = make_tables(net, device=cuda)
    dt = make_device_tables(board, device=cuda)
    db = sample_mixed(np.random.default_rng(3), len(net), 3000).to(cuda)
    m = _ce_maps(db, t, dt)
    pf, ph, pw, _ = parallelism_search(
        m.pes_ce, _search_ce(m),
        *_pair_layer_tables(t, pair_tables(t.candidates, pes_hint(
            board.pes))))
    par = torch.stack([torch.where(m.valid_b, _per_layer(x, m), 1.0)
                       for x in (pf, ph, pw)], -1)
    dims = torch.stack([t.F, t.CKK, t.OH, t.OW], 1)
    reset_launches()
    tot, cyc = mccm_latency(dims, par)
    assert launches()["mccm_latency"] == 1
    rtot, rcyc = mccm_latency_ref(dims, par)
    assert torch.equal(tot, rtot) and torch.equal(cyc, rcyc)
    assert torch.equal(cyc, layer_state(db, t, dt, m, (pf, ph, pw), 2).comp)
    rng = np.random.default_rng(4)
    dims = torch.from_numpy(rng.integers(0, 4096, (77, 4)).astype(
        np.float32)).to(cuda)
    par = torch.from_numpy(rng.choice([1, 3, 7, 24, 512], (131, 77, 3))
                           .astype(np.float32)).to(cuda)
    for k, r in zip(mccm_latency(dims, par), mccm_latency_ref(dims, par)):
        assert torch.equal(k, r)


@pytest.mark.parametrize("C,H,W,F,K,stride,par,dtype", [
    (3, 16, 16, 8, 3, 1, (4, 4, 4), torch.float32),
    (4, 15, 15, 6, 3, 2, (4, 3, 5), torch.float32),
    (8, 10, 10, 16, 5, 1, (16, 2, 3), torch.float32),
    (2, 9, 9, 3, 3, 1, (2, 2, 2), torch.float32),
    (64, 30, 30, 96, 3, 1, (12, 8, 21), torch.float32),
    (256, 16, 16, 100, 1, 2, (1, 1, 512), torch.float32),
    (16, 15, 15, 6, 3, 2, (4, 3, 5), torch.bfloat16),
])
def test_conv_ce_kernel_equals_plain_on_card(cuda, C, H, W, F, K, stride,
                                             par, dtype):
    rng = np.random.default_rng(C * H + F)
    x = torch.from_numpy(rng.standard_normal((C, H, W), dtype=np.float32)
                         ).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((F, C, K, K), dtype=np.float32)
                         ).to(cuda, dtype)
    reset_launches()
    got = conv_ce(x, w, stride=stride, par_f=par[0], par_oh=par[1],
                  par_ow=par[2])
    assert launches()["conv_ce"] == 1
    want = conv_ref(x, w, stride)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    OH, OW = got.shape[1:]
    assert grid_size(F, OH, OW, *par) == \
        -(-F // par[0]) * -(-OH // par[1]) * -(-OW // par[2])


def test_conv_ce_grid_limit_raises(cuda):
    x = torch.zeros(1, 70000, 1, device=cuda)
    w = torch.zeros(1, 1, 1, 1, device=cuda)
    with pytest.raises(ValueError, match="65535"):
        conv_ce(x, w, par_f=1, par_oh=1, par_ow=1)
