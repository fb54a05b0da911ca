"""The port on the card: each CUDA kernel (the parallelism search, the Eq. 1
latency sweep, the CE convolution, flash attention) against its plain
PyTorch version, the Session's main path through the search kernel, the
schedule layer's plane and artifacts against the CPU's, multinet
(``joint_evaluate``, ``Session.deploy`` and the search kernel on slice
boards) against the CPU's, the design-axis mesh (a sharded
``evaluate_batch`` and island search, four shards of one card and one
shard a card where there are several) against the unsharded calls, the
LM serving path through the flash
kernel, training: a reduced Llama step and the flash-attention
Function's gradients against the CPU's, and the LM mesh (four gloo ranks
on the card, and one) against ``golden_mesh.npz`` and the unsharded
route.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when
no card is visible (the decision is made in the fixture, never at import).
On a machine with an H100, ``nvcc`` and no JAX:

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.api import Session, get_board, get_cnn
from repro_torch.cnn.registry import CNN_NAMES, DEEP_CNN_NAMES
from repro_torch.core.batch_eval import (_ce_maps, _pair_layer_tables,
                                         _search_ce, make_device_tables,
                                         make_tables, pes_hint)
from repro_torch.core.dse import encode_specs, sample_mixed
from repro_torch.fpga.archs import ARCH_NAMES, make_arch
from repro_torch.fpga.boards import BOARD_NAMES
from repro_torch.configs import get_config
from repro_torch.kernels.conv_ce import conv_ce, conv_ref, grid_size
from repro_torch.kernels import copies
from repro_torch.kernels.flash_attn import flash_attention, flash_fwd_ref
from repro_torch.kernels.flash_attn.ops import (HEAD_DIMS, f32_plan,
                                                launch_plan)
from repro_torch.kernels.flash_attn.ref import excess
from repro_torch.kernels.mccm_eval import (launches, mccm_latency,
                                           mccm_latency_ref, pair_tables,
                                           parallelism_search,
                                           parallelism_search_ref,
                                           reset_launches)
from repro_torch.kernels.mccm_eval import ops as mccm_ops
from repro_torch.core.batch_eval import LayerState
from repro_torch.schedule import coarse_state, plane_of_state

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
    """⟨pf, ph, pw⟩ and the cost equal bit for bit, inf and NaN where the
    plain version has them: both add each CE's layers in ascending
    order."""
    ker = parallelism_search(*args)
    ref = parallelism_search_ref(*args)
    torch.cuda.synchronize()
    for name, k, r in zip(("pf", "ph", "pw"), ker[:3], ref[:3]):
        assert torch.equal(k, r), f"{label} {name}"
    k, r = ker[3], ref[3]
    assert torch.equal(torch.isinf(k), torch.isinf(r)), f"{label} cost inf"
    assert torch.equal(torch.isnan(k), torch.isnan(r)), f"{label} cost NaN"
    fin = torch.isfinite(r)
    assert torch.equal(k[fin], r[fin]), f"{label} cost"
    return ker


@pytest.mark.parametrize("cnn", CNN_NAMES + DEEP_CNN_NAMES)
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


@pytest.mark.parametrize("net_layers,pes,L,shows", [
    (53, 100_000, 160, "P=324"),
    (180, 2520, 192, "L=192"),
    (180, 100_000, 192, "L=192, rows past the staged ones"),
    (240, 100_000, 256, "L=256, rows past the staged ones"),
    (264, 2520, 288, "DenseNet-264, L=288, rows past the staged ones"),
])
def test_kernel_equals_plain_past_the_ladder(cuda, net_layers, pes, L,
                                             shows):
    """A board beyond the PES_HINTS ladder (no pruning: P = 324),
    synthetic nets padded to 192 and 256 layers, and DenseNet-264's
    designs on the ZCU102's PEs, padded to 288 layers; where L·(P + K)
    floats pass the shared memory, layers past the staged rows come from
    L2 (DenseNet-264: 241 staged, its last 23 live rows unstaged)."""
    from repro_torch.kernels.mccm_eval import last_launch, search_plan
    from torch_search_cases import port_inputs, synthetic_net
    net = {53: get_cnn("resnet50"), 264: get_cnn("densenet264")}.get(
        net_layers) or synthetic_net(net_layers)
    args = port_inputs(net, pes, 300, net_layers, device=cuda)
    P = args[2].shape[1]
    assert args[1].shape[1] == L and P == (324 if pes > 65536 else 219)
    _assert_kernel_equals_plain(args, shows)
    plan = last_launch()
    assert plan == search_plan(300, L, P, args[5].numel())
    if "past" in shows:
        assert plan.staged_rows < net_layers     # mapped rows unstaged
    else:
        assert plan.staged_rows == L
    if net_layers == 264:
        assert (plan.staged_rows, net_layers - plan.staged_rows) == (241, 23)
        assert bool((args[1][:, plan.staged_rows:] >= 0).any())


@pytest.mark.parametrize("B", [1, 17, 2047, 5000])
def test_kernel_batch_sizes(cuda, B):
    """One design; a batch that is not a multiple of a block's warps; one
    that makes each block stride over several slots."""
    from repro_torch.kernels.mccm_eval import last_launch, search_plan
    from torch_search_cases import port_inputs
    args = port_inputs(get_cnn("resnet50"), 2520, B, B, device=cuda)
    _assert_kernel_equals_plain(args, f"B={B}")
    assert last_launch() == search_plan(B, *args[2].shape, args[5].numel())


@pytest.mark.parametrize("P", [1, 40, 225, 353])
def test_kernel_pair_lists_off_the_batch_path(cuda, P):
    """Pair lists no board gives: one pair and 40 (7 a lane, most lanes
    empty), 225 (9 a lane), 353 (two groups of 352)."""
    from repro_torch.kernels.mccm_eval import NPLS, last_launch
    from torch_search_cases import tie_inputs
    args = tie_inputs(B=50, P=P, device=cuda)
    _assert_kernel_equals_plain(args, f"P={P}")
    plan = last_launch()
    assert plan.npl == next((n for n in NPLS if 32 * n >= P), NPLS[-1])
    assert plan.pair_groups == (2 if P == 353 else 1)


def test_kernel_ces_with_pes_and_no_layer(cuda):
    """A CE that owns no layer but has PEs takes its first feasible pair
    at cost 0; with too few PEs for any pair, pair 0 at inf."""
    from torch_search_cases import give_absent_ces_pes, port_inputs
    args = port_inputs(get_cnn("resnet50"), 2520, 500, 9, device=cuda)
    absent = give_absent_ces_pes(args, 10)
    _, _, _, cost = _assert_kernel_equals_plain(args, "absent CEs")
    c = cost[absent]
    assert bool(((c == 0) | torch.isinf(c)).all())
    assert bool((c == 0).any()) and bool(torch.isinf(c).any())


def test_kernel_ties_go_to_the_first_pair(cuda):
    """Pairs whose costs tie, in different lanes and in the two pair
    groups of a 400-pair list: the kernel picks what the plain version
    picks, the first."""
    from torch_search_cases import tie_inputs
    args = tie_inputs(device=cuda)
    pf, ph, pw, cost = _assert_kernel_equals_plain(args, "ties")
    fin = torch.isfinite(cost)
    assert bool(fin.any()) and bool((~fin).any())


@pytest.mark.parametrize("K,cand_scale,shows", [
    (20, 1.0, "the pw table"),
    (40, 1.0, "more than 32 candidates: binary search"),
    (20, 300.0, "candidates past the table: binary search"),
])
def test_kernel_pw_index_routes(cuda, K, cand_scale, shows):
    """Each way the kernel finds pw's index: its table, and the binary
    search where the table cannot hold the candidates; PE counts from
    1e-20 to 3e25."""
    from torch_search_cases import tie_inputs
    args = tie_inputs(B=40, K=K, device=cuda)
    args[5] = args[5] * cand_scale
    rng = np.random.default_rng(K)
    args[0] = torch.from_numpy(rng.choice(
        [0.0, 1e-20, 0.7, 5.0, 40.0, 1e4, 3e25], (40, 16))
        .astype(np.float32)).to(cuda)
    _assert_kernel_equals_plain(args, shows)


def test_kernel_orders_negative_costs(cuda):
    """The argmin orders costs as floats, below zero too (no Eq. 1 cost
    is negative, but the plain version takes any fc)."""
    from torch_search_cases import tie_inputs
    args = tie_inputs(device=cuda)
    sign = torch.where(torch.arange(args[2].shape[1], device=cuda) % 3 == 1,
                       -1.0, 1.0)
    args[2] = args[2] * sign
    _, _, _, cost = _assert_kernel_equals_plain(args, "negative")
    assert bool((cost < 0).any())


@pytest.mark.parametrize("where", ["every pair of a row", "some pairs"])
def test_kernel_takes_the_first_nan_cost(cuda, where):
    """A NaN in fc_pair makes the costs of the pairs it reaches NaN, and
    the argmin takes the first NaN, as torch.argmin does.  One CE has
    PEs and owns every mapped layer, so the plain version's one-hot
    product carries the NaN to no other cost."""
    from torch_search_cases import tie_inputs
    args = tie_inputs(B=12, device=cuda)
    args[1] = torch.where(args[1] > 0, 0, args[1])
    args[0] = torch.zeros_like(args[0])
    args[0][:, 0] = torch.tensor([1.0, 5.0, 12.0, 40.0] * 3, device=cuda)
    fc = args[2].clone()
    if where == "every pair of a row":
        fc[3] = torch.nan
    else:
        fc[5, 2::9] = torch.nan
    args[2] = fc
    pf, ph, pw, cost = _assert_kernel_equals_plain(args, where)
    assert bool(torch.isnan(cost[:, 0]).all())
    assert bool(torch.isinf(cost[:, 1:]).all())


def test_kernel_reads_unaligned_tables(cuda):
    """fc_pair and coh_pair off a 16-byte boundary (views one float into
    a buffer) are staged a float a load, with the same result."""
    from torch_search_cases import port_inputs
    args = port_inputs(get_cnn("resnet50"), 2520, 64, 12, device=cuda)
    for i in (2, 3):
        buf = torch.empty(args[i].numel() + 1, device=cuda)
        view = buf[1:].view(args[i].shape)
        view.copy_(args[i])
        assert view.data_ptr() % 16 and view.is_contiguous()
        args[i] = view
    _assert_kernel_equals_plain(args, "unaligned")


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


def _no_host_route(*args, **kwargs):
    raise AssertionError("the DesignBatch went through the host")


@pytest.mark.parametrize("where", ["host", "card"])
def test_invalid_rows_never_reach_the_batch_path_on_card(cuda, where,
                                                         monkeypatch):
    """A DesignBatch with broken rows, handed over from the host or
    already on the card: the card's Session checks it there and raises
    the CPU Session's INVALID_INPUT, word for word, before anything of
    the batch path runs.  A valid batch then evaluates without the
    numpy route, equal to the CPU's."""
    from repro_torch.api import EvalError
    from repro_torch.core import session as port_session
    from repro_torch.core.dse import encoding as enc
    net, board = get_cnn("resnet50"), get_board("zcu102")
    db = sample_mixed(np.random.default_rng(0), len(net), 3000)
    nce = db.seg_nce.clone()
    nce[[7, 2500], 0] = 40
    bad = enc.DesignBatch(db.seg_end, db.seg_pipe, nce, db.inter_pipe)
    with pytest.raises(EvalError) as want:
        Session(board, device="cpu").evaluate(bad, net)
    assert "2 invalid DesignBatch row(s), first at index 7 " \
        in str(want.value)
    real, reached = port_session.evaluate_batch, []

    def spy(*args, **kwargs):
        reached.append(args[0].seg_end.device.type)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_session, "evaluate_batch", spy)
    monkeypatch.setattr(enc, "validate_batch", _no_host_route)
    monkeypatch.setattr(enc.DesignBatch, "to_numpy", _no_host_route)
    ses = Session(board, device=str(cuda))
    if where == "card":
        bad, db = bad.to(cuda), db.to(cuda)
    with pytest.raises(EvalError) as got:
        ses.evaluate(bad, net)
    assert got.value.code == EvalError.INVALID_INPUT
    assert str(got.value) == str(want.value)
    assert reached == [] and ses.stats.batch_designs == 0
    got = ses.evaluate(db, net)
    assert reached == [cuda.type] and ses.stats.batch_designs == 3000
    monkeypatch.undo()
    want = Session(board, device="cpu").evaluate(db.to("cpu"), net)
    for k, w in want.items():
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


def _latency_on_card(cuda, dims, par):
    """The kernel and the plain version on the card, bit for bit (NaN
    where the plain version has NaN); one launch, no input copied."""
    dims = torch.as_tensor(dims).to(cuda)
    par = torch.as_tensor(par).to(cuda) if not torch.is_tensor(par) else par
    reset_launches()
    tot, cyc = mccm_latency(dims, par)
    torch.cuda.synchronize()
    assert launches()["mccm_latency"] == 1
    assert copies()["mccm_latency"] == 0
    rtot, rcyc = mccm_latency_ref(dims, par)
    torch.testing.assert_close(cyc, rcyc, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(tot, rtot, rtol=0, atol=0, equal_nan=True)
    for k, r in ((tot, rtot), (cyc, rcyc)):      # the sign of a zero too
        keep = ~torch.isnan(r)
        assert torch.equal(k[keep].view(torch.int32),
                           r[keep].view(torch.int32))
    return tot, cyc


@pytest.mark.parametrize("B", [1, 63, 2049, 100_003])
def test_mccm_latency_ragged_batches_on_card(cuda, B):
    """Batches that end inside a tile, a chunk and a 16-byte piece, up to
    several tiles a block, at 160 layers."""
    from torch_search_cases import latency_inputs
    _latency_on_card(cuda, *latency_inputs(B, 160, seed=B))


@pytest.mark.parametrize("L", [1, 53, 160, mccm_ops.LATENCY_MAX_L])
def test_mccm_latency_layer_counts_on_card(cuda, L):
    """One layer to the most the kernel takes: tiles of 4 designs at odd
    L, 1 at L a multiple of 4, rows longer than the consumers."""
    from torch_search_cases import latency_inputs
    _latency_on_card(cuda, *latency_inputs(777, L, seed=L))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("L", [53, 160])
def test_mccm_latency_reads_misaligned_par_on_card(cuda, offset, L):
    """A par view 4, 8 or 12 bytes past a 16-byte boundary (storage
    offset 1 to 3) is read where it lies, without a copy, and gives the
    plain version's bits."""
    from torch_search_cases import latency_inputs
    dims, par = latency_inputs(2049, L, seed=offset)
    flat = torch.zeros(offset + par.size, dtype=torch.float32, device=cuda)
    flat[offset:] = torch.from_numpy(par.ravel()).to(cuda)
    view = flat[offset:].view(par.shape)
    assert view.data_ptr() % 16 == 4 * offset and view.is_contiguous()
    _latency_on_card(cuda, dims, view)


@pytest.mark.parametrize("kind", ["zero", "inf", "nan"])
def test_mccm_latency_nonfinite_on_card(cuda, kind):
    """Zeros, infinities and NaNs in par give the plain version's inf and
    NaN in the same places, and its other bits."""
    from torch_search_cases import latency_nonfinite_inputs
    _, cyc = _latency_on_card(cuda, *latency_nonfinite_inputs(kind))
    assert not torch.isfinite(cyc).all()


def test_mccm_latency_order_sensitive_total_on_card(cuda):
    """Totals that the order of the sum decides: the kernel's equal the
    layers added left to right, not a tree."""
    from torch_search_cases import (ascending_sum, latency_order_inputs,
                                    tree_sum)
    tot, cyc = _latency_on_card(cuda, *latency_order_inputs(B=300))
    tot, cyc = tot.cpu().numpy(), cyc.cpu().numpy()
    np.testing.assert_array_equal(tot, ascending_sum(cyc))
    assert (tot != tree_sum(cyc)).all()


def test_mccm_latency_is_deterministic_on_card(cuda):
    """Two launches on the same inputs give the same bits."""
    from torch_search_cases import latency_inputs
    dims, par = (torch.from_numpy(a).to(cuda)
                 for a in latency_inputs(50_001, 160, seed=9))
    a, b = mccm_latency(dims, par), mccm_latency(dims, par)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("B", [1, 63, 2048, 100_000])
def test_mccm_latency_plan_equals_its_mirror(cuda, B):
    """The plan the library reports, and runs, equals ``ops.latency_plan``
    at every L the tests run."""
    for L in (1, 2, 3, 53, 160, 1001, mccm_ops.LATENCY_MAX_L):
        assert mccm_ops.latency_launch_plan(B, L) == \
            mccm_ops.latency_plan(B, L), (B, L)
    dims = torch.ones(160, 4, device=cuda)
    mccm_latency(dims, torch.ones(B, 160, 3, device=cuda))
    assert mccm_ops.last_latency_launch() == mccm_ops.latency_plan(B, 160)


@pytest.mark.parametrize("C,H,W,F,K,stride,par,dtype,shows", [
    (3, 16, 16, 8, 3, 1, (4, 4, 4), torch.float32, ""),
    (4, 15, 15, 6, 3, 2, (4, 3, 5), torch.float32, ""),
    (8, 10, 10, 16, 5, 1, (16, 2, 3), torch.float32, ""),
    (2, 9, 9, 3, 3, 1, (2, 2, 2), torch.float32, ""),
    (64, 30, 30, 96, 3, 1, (12, 8, 21), torch.float32, ""),
    (256, 16, 16, 100, 1, 2, (1, 1, 512), torch.float32, ""),
    (16, 15, 15, 6, 3, 2, (4, 3, 5), torch.bfloat16, ""),
    # the Builder's tiles at ResNet-50 widths (segmented, segmented_rr,
    # hybrid on ZCU102)
    (256, 16, 16, 256, 3, 1, (24, 3, 3), torch.float32, ""),
    (1024, 14, 14, 256, 1, 1, (64, 1, 3), torch.float32, ""),
    (512, 9, 9, 512, 3, 1, (128, 2, 8), torch.float32, ""),
    # a CE's whole PE count on ZCU102 in one tile, along F and spatially
    (16, 12, 12, 2600, 3, 1, (2520, 1, 1), torch.float32, "ragged_f"),
    (64, 20, 20, 70, 3, 1, (35, 8, 9), torch.float32, ""),
    # ResNet-50's first layer: C 3, 7x7, stride 2, padded input
    (3, 229, 229, 64, 7, 2, (6, 3, 12), torch.float32, ""),
    # 1x1 at stride 2
    (256, 56, 56, 512, 1, 2, (12, 4, 4), torch.float32, ""),
    (100, 12, 12, 40, 3, 1, (8, 4, 4), torch.float32, "ragged_chunk"),
    (20, 17, 19, 37, 3, 2, (8, 3, 4), torch.float32, "ragged"),
    (64, 16, 16, 96, 3, 1, (24, 3, 3), torch.bfloat16, ""),
    (20, 17, 19, 37, 3, 2, (8, 3, 4), torch.bfloat16, "ragged"),
])
def test_conv_ce_kernel_equals_plain_on_card(cuda, C, H, W, F, K, stride,
                                             par, dtype, shows):
    """Bit for bit equal to the plain version, with the grid the library
    reports equal to Eq. 1's; ``shows`` names what a case exercises: a
    ragged tail in F, OH and OW at once, in F alone, or a last channel
    chunk shorter than the plan's."""
    from repro_torch.kernels.conv_ce import ops as conv_ops
    rng = np.random.default_rng(C * H + F)
    x = torch.from_numpy(rng.standard_normal((C, H, W), dtype=np.float32)
                         ).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((F, C, K, K), dtype=np.float32)
                         ).to(cuda, dtype)
    reset_launches()
    got = conv_ce(x, w, stride=stride, par_f=par[0], par_oh=par[1],
                  par_ow=par[2])
    assert launches()["conv_ce"] == 1
    launch = conv_ops.last_launch()
    want = conv_ref(x, w, stride)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    OH, OW = got.shape[1:]
    eq1 = (-(-F // par[0]), -(-OH // par[1]), -(-OW // par[2]))
    assert launch.grid == launch.plan.grid == eq1
    assert grid_size(F, OH, OW, *par) == math.prod(eq1)
    if shows == "ragged":
        assert F % par[0] and OH % par[1] and OW % par[2]
    if shows == "ragged_f":
        assert F % par[0]
    if shows == "ragged_chunk":
        assert C % launch.plan.cc


def test_conv_ce_grid_limit_raises(cuda):
    x = torch.zeros(1, 70000, 1, device=cuda)
    w = torch.zeros(1, 1, 1, 1, device=cuda)
    with pytest.raises(ValueError, match="65535"):
        conv_ce(x, w, par_f=1, par_oh=1, par_ow=1)


# the cases of tests/test_kernels.py:18-24, a q_offset case and one whose
# inputs are read through non-contiguous strides
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,q_offset,dtype", [
    (2, 128, 128, 4, 2, 64, True, None, 0, torch.float32),
    (1, 200, 200, 2, 2, 32, True, 64, 0, torch.float32),
    (2, 64, 256, 4, 4, 64, False, None, 0, torch.float32),
    (1, 1, 300, 4, 2, 64, False, None, 0, torch.float32),
    (2, 96, 96, 2, 1, 128, True, None, 0, torch.bfloat16),
    (1, 70, 200, 4, 2, 80, True, 50, 130, torch.bfloat16),
    (3, 100, 100, 8, 8, 16, True, None, -20, torch.float32),
])
def test_flash_kernel_equals_plain_on_card(cuda, B, Sq, Sk, H, Hkv, D,
                                           causal, window, q_offset, dtype):
    rng = np.random.default_rng(Sq + Sk + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, s, h, D), dtype=np.float32)).to(cuda, dtype)
        for s, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    reset_launches()
    got = flash_attention(q, k, v, **kw)
    assert launches()["flash_fwd"] == 1
    want = flash_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    # element by element: one bf16 ulp (2**-7·|want|) plus 2e-5 in bf16,
    # 2e-5 in f32 (ref.TOLERANCE)
    assert excess(got, want) <= 0, (got - want).abs().max()
    # the same read through strides: each a view of every other head-dim
    # block of a wider tensor
    qs, ks, vs = (torch.cat([t, t], -1)[..., :D] for t in (q, k, v))
    assert not qs.is_contiguous() and qs.stride(-1) == 1
    assert torch.equal(flash_attention(qs, ks, vs, **kw), got)


# each kernel on its own: every head dim, GQA ratios 1, 4 and 8, Sq != Sk
# with q_offset (negative too), a ragged 4000-token case, windows and
# non-causal attention
FLASH_CASES = [
    *[(2, 150, 150, 4, 4, D, True, None, 0) for D in HEAD_DIMS],
    (1, 130, 300, 8, 2, 64, True, None, 170),
    (2, 100, 260, 8, 1, 80, True, 70, 160),
    (1, 70, 70, 8, 8, 128, True, None, -30),
    (1, 4000, 4000, 4, 1, 64, True, None, 0),
    (1, 1000, 1000, 4, 1, 64, True, 300, 0),
    (2, 200, 333, 4, 4, 96, False, None, 0),
    (1, 257, 129, 8, 2, 48, False, 64, 100),
]


def _flash_case(cuda, dtype, B, Sq, Sk, H, Hkv, D, causal, window, q_offset):
    """One launch on random inputs: no copy, and within ``ref.TOLERANCE``
    of the plain version element by element."""
    rng = np.random.default_rng(Sq + Sk + D + H)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, s, h, D), dtype=np.float32)).to(cuda, dtype)
        for s, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    reset_launches()
    got = flash_attention(q, k, v, **kw)
    assert launches()["flash_fwd"] == 1 and copies()["flash_fwd"] == 0
    want = flash_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert excess(got, want) <= 0, (got.float() - want.float()).abs().max()


# the bf16 kernel (tensor cores)
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,q_offset",
                         FLASH_CASES)
def test_flash_bf16_kernel_equals_plain_on_card(cuda, B, Sq, Sk, H, Hkv, D,
                                                causal, window, q_offset):
    _flash_case(cuda, torch.bfloat16, B, Sq, Sk, H, Hkv, D, causal, window,
                q_offset)


# the f32 kernel (FMA units)
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,q_offset",
                         FLASH_CASES)
def test_flash_f32_kernel_equals_plain_on_card(cuda, B, Sq, Sk, H, Hkv, D,
                                               causal, window, q_offset):
    _flash_case(cuda, torch.float32, B, Sq, Sk, H, Hkv, D, causal, window,
                q_offset)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_f32_plan_equals_its_mirror(cuda, D):
    """The plan the f32 library reports equals ``ops.f32_plan``, which
    the CPU tests hold to the card's limits."""
    assert launch_plan(D, torch.float32) == f32_plan(D)


def _fully_masked_rows_give_zero(cuda, dtype):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 200, h, 64), dtype=np.float32)).to(cuda, dtype)
        for h in (4, 2, 2))
    out = flash_attention(q, k, v, causal=True, q_offset=-150)
    torch.cuda.synchronize()
    assert not bool(out[:, :150].any())
    assert bool(out[:, 150:].abs().sum(-1).gt(0).all())
    assert excess(out, flash_fwd_ref(q, k, v, causal=True,
                                     q_offset=-150)) <= 0
    out = flash_attention(q, k[:, :0], v[:, :0], causal=False)
    assert out.shape == q.shape and not bool(out.any())


def test_flash_bf16_fully_masked_rows_give_zero_on_card(cuda):
    _fully_masked_rows_give_zero(cuda, torch.bfloat16)


def test_flash_f32_fully_masked_rows_give_zero_on_card(cuda):
    _fully_masked_rows_give_zero(cuda, torch.float32)


def test_flash_bf16_keeps_p_in_f32_on_card(cuda):
    """tests/test_torch_flash_attn.py::test_bf16_keeps_p_in_f32 on the
    card: p = exp(-177/256), which bf16 rounds to 0.5, must give 5.8e-4,
    not 0."""
    D = 16
    q = torch.zeros(1, 1, 1, D)
    q[..., 0] = 1.0
    k = torch.zeros(1, 2, 1, D)
    k[0, 1, 0, 0] = -177 / 256
    v = torch.stack([torch.full((D,), -0.5), torch.ones(D)])[None, :, None]
    q, k, v = (t.to(cuda, torch.bfloat16) for t in (q, k, v))
    got = flash_attention(q, k, v, causal=False, scale=1.0)
    x = math.exp(-177 / 256)
    want = torch.full(got.shape, (x - 0.5) / (1 + x)).bfloat16().to(cuda)
    assert excess(got, want) <= 0, got


def _reads_fused_qkv_views_without_a_copy(cuda, D, dtype):
    """q, k and v as head-dim slices of one fused projection (B, S,
    (H + 2 Hkv)·D): read through their strides, no copy, and equal to the
    contiguous tensors' result bit for bit; a view one element off a
    16-byte boundary is copied once, and counted."""
    B, S, H, Hkv = 2, 300, 8, 2
    rng = np.random.default_rng(D)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, (H + 2 * Hkv) * D), dtype=np.float32)).to(cuda, dtype)
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + Hkv) * D].view(B, S, Hkv, D)
    v = qkv[..., (H + Hkv) * D:].view(B, S, Hkv, D)
    reset_launches()
    got = flash_attention(q, k, v, causal=True)
    assert launches()["flash_fwd"] == 1 and copies()["flash_fwd"] == 0
    want = flash_attention(*(t.contiguous() for t in (q, k, v)), causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # a view the kernel cannot read is copied once, and counted
    reset_launches()
    off = qkv[..., 1:1 + H * D].view(B, S, H, D)
    assert torch.equal(flash_attention(off, k, v, causal=True),
                       flash_attention(off.contiguous(), k, v, causal=True))
    assert copies()["flash_fwd"] == 1


@pytest.mark.parametrize("D", [64, 80, 128])
def test_flash_bf16_reads_fused_qkv_views_without_a_copy(cuda, D):
    _reads_fused_qkv_views_without_a_copy(cuda, D, torch.bfloat16)


@pytest.mark.parametrize("D", [16, 64, 80, 128])
def test_flash_f32_reads_fused_qkv_views_without_a_copy(cuda, D):
    _reads_fused_qkv_views_without_a_copy(cuda, D, torch.float32)


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(1, 8, 2, 24, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q.half(), q)


def test_serve_engine_on_card_equals_cpu(cuda):
    """The reduced Llama config in f32: greedy tokens on the card (flash
    kernel in prefill past 2048 tokens) equal the CPU route's."""
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("llama3.2-1b").reduced().replace(dtype="float32")
    cpu = ServeEngine(cfg, device="cpu")
    model = cpu.api.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (2100, 40)]
    want = cpu.generate(model, prompts, max_new_tokens=8).tokens
    reset_launches()
    got = ServeEngine(cfg, device=str(cuda)).generate(
        model.to(cuda), prompts, max_new_tokens=8).tokens
    assert launches()["flash_fwd"] == cfg.n_layers
    assert got == want


# the LM families' attention shapes: non-causal at Sq = Sk (an encoder),
# Sq 512 over 4096 keys (cross-attention at prefill) and Sq 1 over 4096
# (cross-attention in every decode step), Whisper's 8 heads of 64
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk", [(2, 4096, 4096), (4, 512, 4096),
                                     (4, 1, 4096)])
def test_flash_non_causal_family_shapes_on_card(cuda, dtype, B, Sq, Sk):
    _flash_case(cuda, dtype, B, Sq, Sk, 8, 8, 64, False, None, 0)


def test_moe_layer_on_card_equals_cpu(cuda):
    """One MoE layer at Granite-3.0-1B-A400M's width (d 1024, 32 experts
    of 512, top-8) in f32 on 2 x 300 tokens: the card routes every token
    to the CPU's experts and drops the same assignments; the output meets
    the CPU's within 1e-5 of its largest |value| (cuBLAS and the CPU sum
    the experts' products in other orders)."""
    from repro_torch.models import moe
    from repro_torch.models.runtime import Runtime
    cfg = get_config("granite-moe-1b-a400m").replace(dtype="float32")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 300, cfg.d_model, generator=torch.Generator(
        ).manual_seed(1))
    want, aux = moe.moe_fwd(p, x, cfg, Runtime())
    e_cpu = moe._route(x.reshape(-1, cfg.d_model), p["router"], cfg)[0]
    p.to(cuda)
    got, aux_card = moe.moe_fwd(p, x.to(cuda), cfg, Runtime())
    e_card = moe._route(x.to(cuda).reshape(-1, cfg.d_model), p["router"],
                        cfg)[0]
    assert torch.equal(e_card.cpu(), e_cpu)
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * max(1.0, scale)
    assert abs(float(aux_card) - float(aux)) <= 1e-5


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "kimi-k2-1t-a32b", "mamba2-370m",
                                  "zamba2-1.2b", "whisper-base",
                                  "internvl2-2b"])
def test_decode_step_reads_nothing_back_on_card(cuda, arch):
    """A decode step of every family only enqueues work: no op in it waits
    for the card (``set_sync_debug_mode("error")`` raises on one), so the
    host runs ahead of the device.  The MoE's rank within an expert once
    used ``bincount``, which reads its max back to the host a layer."""
    from repro_torch.models import get_model
    from repro_torch.models.runtime import Runtime
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    model = api.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(1, cfg.vocab_size, (2, 40), device=cuda)
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, 64, cfg.frontend_dim, device=cuda)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(2, cfg.n_patches, cfg.frontend_dim,
                                       device=cuda)
    _, cache = api.prefill(model, batch, Runtime(), max_len=44)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            logits, cache = api.decode_step(model, cache, toks[:, -1:],
                                            Runtime())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m",
                                  "zamba2-1.2b", "whisper-base",
                                  "internvl2-2b"])
def test_family_serve_on_card_equals_cpu(cuda, arch):
    """Each family's reduced config in f32 on a prompt past 2048 positions
    (Whisper: 2100 frames): greedy tokens on the card (the flash kernel
    where the attention is chunked) equal the CPU route's, with the
    launches ``chip_smoke.flash_launches`` counts."""
    import importlib.util
    from pathlib import Path

    from repro_torch.serve.engine import ServeEngine
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    over = {"max_abs_positions": 2560} if arch == "whisper-base" else {}
    cfg = get_config(arch).reduced().replace(dtype="float32", **over)
    cpu = ServeEngine(cfg, device="cpu")
    model = cpu.api.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    lens = (300, 40) if cfg.family == "encdec" else (2100, 40)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal((2, 2100, cfg.frontend_dim),
                                              dtype=np.float32)
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (2, cfg.n_patches, cfg.frontend_dim), dtype=np.float32)
    want = cpu.generate(model, prompts, max_new_tokens=8,
                        extra_inputs=extra).tokens
    reset_launches()
    got = ServeEngine(cfg, device=str(cuda)).generate(
        model.to(cuda), prompts, max_new_tokens=8, extra_inputs=extra)
    n_pre, n_dec = chip_smoke.flash_launches(cfg, max(lens), 2100)
    assert launches()["flash_fwd"] == n_pre + 8 * n_dec
    assert got.tokens == want


def _train_setup(device, model=None):
    from repro_torch.models import get_model
    from repro_torch.models.runtime import Runtime
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_state, make_train_step
    cfg = get_config("llama3.2-1b").reduced().replace(dtype="float32")
    api = get_model(cfg)
    opt = make_optimizer("adamw", peak_lr=3e-3, warmup=0, total_steps=100)
    rt = Runtime(attn_mode="chunked", remat=True, loss_chunk=12)
    if model is None:
        model = api.init(torch.Generator().manual_seed(0))
    state = init_state(api, opt, model=model.to(device), device=device)
    return cfg, api, rt, state, make_train_step(api, rt, opt, device=device)


def test_train_step_on_card_equals_cpu(cuda):
    """Reduced Llama in f32 (the chunked path: the f32 kernel forward,
    the Function's backward, remat, a loss chunk of 12), from one shared
    state after a CPU step: the loss's gradients on the card within 5e-5
    of each leaf's own scale (its largest |value|) of the CPU's; AdamW's update of the CPU's
    gradients on the card within 1e-6 of the CPU's; then a whole step on
    each: the loss within 1e-5, the grad norm within rtol 1e-5 and every
    param within 1e-2·lr of the CPU's (lr 3e-3).  cuBLAS and the CPU sum
    the same products in other orders, and AdamW's m/sqrt(v) turns a
    relative difference of a gradient element near 0 into the same
    relative difference of its update, up to lr: measured 1.5e-3·lr on
    an H100."""
    import copy
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.configs.base import ShapeSpec
    cfg, api, rt, cpu, cpu_step = _train_setup(torch.device("cpu"))
    shape = ShapeSpec("t", "train", 32, 4)
    cpu, _ = cpu_step(cpu, synth_batch(cfg, shape, 0))
    card_model = copy.deepcopy(cpu.model)
    _, _, _, card, card_step = _train_setup(cuda, card_model)

    def state_on(dev, opt):
        return {"mu": {n: {k: t.clone().to(dev) for k, t in st.items()}
                       for n, st in opt["mu"].items()},
                "count": opt["count"].clone().to(dev)}
    card.opt = state_on(cuda, cpu.opt)
    batch = synth_batch(cfg, shape, 1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for model, dev in ((cpu.model, "cpu"), (card.model, cuda)):
        loss, _ = api.loss(model, {k: v.to(dev) for k, v in tb.items()}, rt)
        names, ps = zip(*model.named_parameters())
        grads[str(dev)] = dict(zip(names, torch.autograd.grad(loss, ps)))
    want_g, got_g = grads["cpu"], grads[str(cuda)]
    for n, w in want_g.items():
        scale = float(w.abs().max())
        assert float((got_g[n].cpu() - w).abs().max()) <= 5e-5 * scale, n
    from repro_torch.train.optimizer import make_optimizer
    opt = make_optimizer("adamw", peak_lr=3e-3, warmup=0, total_steps=100)
    params = dict(cpu.model.named_parameters())
    # copies of the parameters and the state, updated in place
    want_p = {n: p.detach().clone() for n, p in params.items()}
    want_n = opt.update_(want_g, state_on("cpu", cpu.opt), want_p)
    got_p = {n: p.detach().to(cuda) for n, p in params.items()}
    got_n = opt.update_({n: g.to(cuda) for n, g in want_g.items()},
                        state_on(cuda, cpu.opt), got_p)
    assert abs(got_n.item() - want_n.item()) <= 1e-6 * want_n.item()
    for n, w in want_p.items():
        assert float((got_p[n].cpu() - w).abs().max()) <= 1e-6, n
    reset_launches()
    card, m_card = card_step(card, batch)
    # a chunked call a layer, again in remat's recompute
    assert launches()["flash_fwd"] == 2 * cfg.n_layers
    cpu, m_cpu = cpu_step(cpu, batch)
    assert abs(m_card["loss"].item() - m_cpu["loss"].item()) <= 1e-5
    assert abs(m_card["grad_norm"].item() - m_cpu["grad_norm"].item()) <= \
        1e-5 * m_cpu["grad_norm"].item()
    for (n, a), b in zip(card.model.named_parameters(),
                         cpu.model.parameters()):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= \
            1e-2 * 3e-3, n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,Sq,Sk", [(True, 2100, 2100),
                                          (False, 300, 2100)])
def test_flash_function_grads_on_card_equal_cpu(cuda, dtype, causal, Sq,
                                                Sk):
    """The flash-attention Function's gradients (GQA 8/2, head dim 64, the
    JAX package's default blocks) on the card against its CPU run on the
    same inputs: within 1e-5 of the CPU's largest |gradient| in f32, 1e-2
    in bf16 (the kernel's output may part from the plain forward's by one
    bf16 ulp, and each of p and ds is rounded to bf16)."""
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(2, S, h, 64, generator=gen).to(dtype)
                     for S, h in ((Sq, 8), (Sk, 2), (Sk, 2), (Sq, 8)))

    def grads(dev):
        x = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out = L.chunked_attention(*x, causal=causal, window=None)
        return torch.autograd.grad(out, x, dout.to(dev))
    want = grads("cpu")
    reset_launches()
    got = grads(cuda)
    assert launches()["flash_fwd"] == 1
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        scale = float(w.float().abs().max())
        err = float((g.cpu().float() - w.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m",
                                  "zamba2-1.2b", "whisper-base"])
def test_train_loss_backward_reads_nothing_back_on_card(cuda, arch):
    """The loss and its backward of the families written for serving (the
    MoE dispatch's index writes, the SSD scan's chunk loop, the encoder)
    only enqueue work: ``set_sync_debug_mode("error")`` raises on an op
    that waits for the card."""
    from repro_torch.models import get_model
    from repro_torch.models.runtime import Runtime
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    model = api.init(torch.Generator(device=cuda).manual_seed(0))
    model.requires_grad_(True)
    toks = torch.randint(1, cfg.vocab_size, (2, 33), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, 64, cfg.frontend_dim, device=cuda)
    rt = Runtime(attn_mode="chunked", remat=True, loss_chunk=12)
    api.loss(model, batch, rt)[0].backward()              # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, _ = api.loss(model, batch, rt)
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(p.grad is None or bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


def test_explore_on_card_equals_cpu(cuda):
    """The card's small explore, random and search, against the CPU plain
    path: the same designs and front, the metrics within 1e-5; the search
    kernel launched once per chunk of every generation."""
    from repro_torch.core.dse import SearchConfig
    net = get_cnn("mobilenetv2")
    card = Session(get_board("zc706"), device=str(cuda))
    cpu = Session(get_board("zc706"), device="cpu")
    for kw in (dict(n=999, chunk=256, seed=5),
               dict(n=512, strategy="search", seed=8,
                    config=SearchConfig(pop_size=128, seed=8))):
        reset_launches()
        got = card.explore(net, **kw)
        n_launch = launches()["parallelism_search"]
        want = cpu.explore(net, **kw)
        assert n_launch == 4, kw             # 4 chunks, 4 generations
        for g, w in zip(got.batch.to_numpy(), want.batch.to_numpy()):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got.front, want.front)
        for k, w in want.metrics.items():
            if k == "n_ces":
                np.testing.assert_array_equal(got.metrics[k], w)
            else:
                np.testing.assert_allclose(got.metrics[k], w, rtol=1e-5,
                                           err_msg=k)
        assert card.compile_stats()["total"] >= 1


def test_faulted_kernel_never_runs_the_plain_version_on_card(cuda,
                                                             monkeypatch):
    """A search kernel that fails on the card: the Session retries it and
    raises BACKEND_FAULT; the plain version never runs on a CUDA tensor."""
    from repro_torch.core import session as port_session
    from repro_torch.core.resilience import EvalError
    calls = {"kernel": 0, "plain": 0}

    def fault(*args):
        calls["kernel"] += 1
        raise RuntimeError("injected launch failure")

    def plain(*args):
        calls["plain"] += 1
        return parallelism_search_ref(*args)

    monkeypatch.setattr(mccm_ops, "parallelism_search_cuda", fault)
    monkeypatch.setattr(mccm_ops, "parallelism_search_ref", plain)
    monkeypatch.setattr(port_session.time, "sleep", lambda s: None)
    net = get_cnn("mobilenetv2")
    ses = Session(get_board("zc706"), device=str(cuda), max_retries=2)
    with pytest.raises(EvalError) as e:
        ses.evaluate([make_arch("segmented", net, 4)], net)
    assert e.value.code == EvalError.BACKEND_FAULT
    with pytest.raises(EvalError) as e:
        ses.explore(net, n=64, chunk=64)
    assert e.value.code == EvalError.BACKEND_FAULT
    assert calls == {"kernel": 4, "plain": 0}
    assert ses.stats.retried == 2 and ses.breaker.is_open


def test_warm_round_adds_no_builds_on_card(cuda):
    from repro_torch.core.dse import SearchConfig
    net = get_cnn("mobilenetv2")
    ses = Session(get_board("zc706"), device=str(cuda))
    for _ in range(2):
        ses.evaluate([make_arch("segmented", net, 4)], net)
        ses.explore(net, n=256, strategy="search",
                    config=SearchConfig(pop_size=128))
        if _ == 0:
            before = ses.compile_stats()["total"]
    assert before >= 1 and ses.compile_stats()["total"] == before


def test_submit_on_card_equals_evaluate_on_card(cuda):
    """The drain on the card: merged probes, a request split at the chunk
    size and another net's request equal the card's evaluate bit for bit,
    one search-kernel launch a planned chunk."""
    from repro_torch.core.dse.encoding import decode_batch
    net, net2 = get_cnn("mobilenetv2"), get_cnn("resnet50")
    with Session(get_board("zc706"), device=str(cuda), chunk=256,
                 linger_s=0.5) as ses:
        big = decode_batch(sample_mixed(np.random.default_rng(0), len(net),
                                        700), len(net))
        probes = [[make_arch(a, net, 4)] for a in ARCH_NAMES]
        other = [make_arch(a, net2, 6) for a in ARCH_NAMES]
        want = [ses.evaluate(d, n) for d, n in
                [(p, net) for p in probes] + [(big, net), (other, net2)]]
        reset_launches()
        futs = [ses.submit(p, net) for p in probes]
        futs += [ses.submit(big, net), ses.submit(other, net2)]
        got = [f.result(timeout=300) for f in futs]
        n_launch = launches()["parallelism_search"]
        stats = ses.stats
        assert stats.megabatches == 1 and stats.coalesced_splits == 1
        assert stats.coalesced_merges >= len(probes)
        assert n_launch == stats.coalesced_chunks
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_faulted_drain_fails_every_future_on_card(cuda, monkeypatch):
    """A search kernel that faults in the drain: the megabatch and each
    request's isolated re-run fail on the card, every future ends as
    BACKEND_FAULT, the plain version never runs and nothing degrades."""
    from repro_torch.core.resilience import EvalError
    calls = {"cuda": 0, "plain": 0}

    def hook(site, route):
        if route == "cuda":
            calls["cuda"] += 1
            raise RuntimeError("injected launch failure")

    def plain(*args):
        calls["plain"] += 1
        return parallelism_search_ref(*args)

    monkeypatch.setattr(mccm_ops, "parallelism_search_ref", plain)
    net = get_cnn("mobilenetv2")
    prev = mccm_ops.set_fault_hook(hook)
    try:
        with Session(get_board("zc706"), device=str(cuda), max_retries=1,
                     linger_s=0.5) as ses:
            futs = [ses.submit([make_arch(a, net, 4)], net)
                    for a in ARCH_NAMES]
            for f in futs:
                with pytest.raises(EvalError) as e:
                    f.result(timeout=300)
                assert e.value.code == EvalError.BACKEND_FAULT
    finally:
        mccm_ops.set_fault_hook(prev)
    # the megabatch and each request alone, each tried twice
    assert calls == {"cuda": 2 * (1 + len(ARCH_NAMES)), "plain": 0}
    assert ses.stats.degraded == 0 and ses.stats.retried == \
        1 + len(ARCH_NAMES)


def _card_and_cpu_planes(device, net, board, db):
    """The plane on the card and on the CPU from the card's layer state."""
    t = make_tables(net, device=device)
    dt = make_device_tables(board, device=device)
    m, st = coarse_state(db.to(device), t, dt)
    card = plane_of_state(t, dt, st, m.pipe_bool, m.valid_b)
    host = plane_of_state(make_tables(net, device="cpu"),
                          make_device_tables(board, device="cpu"),
                          LayerState(*[x.cpu() for x in st]),
                          m.pipe_bool.cpu(), m.valid_b.cpu())
    return card, host, m.valid_b


@pytest.mark.parametrize("cnn,board", [("resnet50", "zcu102"),
                                       ("mobilenetv2", "zc706"),
                                       ("vgg16", "vcu108")])
def test_schedule_plane_on_card_equals_cpu(cuda, cnn, board):
    net = get_cnn(cnn)
    db = sample_mixed(np.random.default_rng(3), len(net), 1024)
    card, host, _ = _card_and_cpu_planes(cuda, net, get_board(board), db)
    assert sorted(card) == sorted(host)
    for k, h in host.items():
        assert card[k].dtype == h.dtype, k
        assert torch.equal(card[k].cpu(), h), k


def test_schedule_all_tie_rows_choose_zero_on_card(cuda):
    """Where every candidate of a valid layer scores the same, the card's
    argmin takes candidate 0, as the CPU's does."""
    n_ties = 0
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        db = encode_specs([make_arch(a, net, n) for a in ARCH_NAMES
                           for n in (2, 5, 9, 11)], len(net))
        card, _, valid = _card_and_cpu_planes(cuda, net, get_board("zc706"),
                                              db)
        score = card["score"]
        ties = (score == score[..., :1]).all(-1) & valid
        n_ties += int(ties.sum())
        assert not bool((card["choice"][ties] != 0).any()), cnn
    assert n_ties > 0


def _assert_close_tree(got, want, where=""):
    """Nested artifact dicts: floats within rtol 1e-5, the rest equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_close_tree(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_tree(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-5, abs_tol=0.0), \
            f"{where}: {got} vs {want}"
    else:
        assert got == want, where


@pytest.mark.parametrize("cnn,board", [("mobilenetv2", "zc706"),
                                       ("resnet50", "zcu102")])
def test_schedule_artifact_on_card_equals_cpu(cuda, cnn, board):
    net = get_cnn(cnn)
    with Session(get_board(board), device="cuda") as gpu, \
            Session(get_board(board), device="cpu") as cpu:
        for arch in ARCH_NAMES:
            spec = make_arch(arch, net, 6)
            got = gpu.schedule(spec, net)
            want = cpu.schedule(spec, net)
            assert got.latency_s <= got.coarse_latency_s
            assert [(l.layer, l.order, l.tile_frac, l.double_buffer)
                    for l in got.layers] == \
                [(l.layer, l.order, l.tile_frac, l.double_buffer)
                 for l in want.layers], arch
            _assert_close_tree(got.to_dict(), want.to_dict(), arch)
        total = gpu.compile_stats()["total"]
        rep = gpu.explain(make_arch("hybrid", net, 6), net,
                          refine="schedule")
        assert rep["schedule"]["latency_s"] <= \
            rep["schedule"]["coarse_latency_s"]
        assert gpu.compile_stats()["total"] == total   # warm: no build


# --------------------------------------------------------------------------
# multinet co-scheduling
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["spatial", "temporal", "hybrid"])
def test_joint_evaluate_on_card_equals_cpu(cuda, mode):
    """``joint_evaluate`` on the card against the CPU port, each mode at
    M = 3: the discrete fields equal, the rest within 1e-5; one search
    launch per lane (the padded lanes one more in the spatial and hybrid
    modes, none in the temporal mode, which copies the last lane)."""
    from repro_torch.core.dse import sample_assign, stack_designs
    from repro_torch.core.multinet import (joint_evaluate, make_multi_tables,
                                           sample_shares)
    names = ("resnet50", "mobilenetv2", "densenet121")
    nets = [get_cnn(n) for n in names]
    rng = np.random.default_rng(2)
    md = stack_designs([sample_mixed(rng, len(n), 300) for n in nets], 4)
    sh = [sample_shares(rng, 300, 4, 3) for _ in range(4)]
    kw = {"spatial": dict(pes_shares=sh[0], buf_shares=sh[1],
                          bw_shares=sh[2]),
          "temporal": dict(time_shares=sh[3], reconfig_s=0.002),
          "hybrid": dict(assign=sample_assign(rng, 300, 4, 3),
                         pes_shares=sh[0], buf_shares=sh[1],
                         bw_shares=sh[2], time_shares=sh[3])}[mode]
    board = get_board("zc706")
    want = joint_evaluate(md, make_multi_tables(nets, slo_s=0.05,
                                                device="cpu"), board,
                          mode=mode, **kw)
    reset_launches()
    got = joint_evaluate(md, make_multi_tables(nets, slo_s=0.05,
                                               device=cuda), board,
                         mode=mode, **kw)
    assert launches()["parallelism_search"] == (3 if mode == "temporal"
                                                else 4)
    for k, w in want.items():
        g = got[k].cpu().numpy()
        if k in ("pes_split", "buf_split", "assign", "per_model_n_ces"):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=k)
        else:
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, err_msg=k)


def test_search_kernel_on_slice_boards_equals_plain(cuda):
    """The search kernel on per-row slice PEs (from one 5 % floor up to
    the full board, pruned for the full board) meets its plain twin bit
    for bit."""
    from repro_torch.core.batch_eval import DeviceTables
    from repro_torch.core.multinet.partition import (
        lane_devices, partition_devices, repair_partition_torch)
    net, board = get_cnn("resnet50"), get_board("zcu102")
    t = make_tables(net, device=cuda)
    dev = make_device_tables(board, device=cuda)
    B = 4096
    rng = np.random.default_rng(7)
    raw = rng.gamma(0.3, 1.0, size=(B, 4)).astype(np.float32)
    raw[:64, 0] = 0.0                  # lane 0 at its floor
    raw[64:128, 1:] = 0.0              # lane 0 takes all but the floors
    shares = torch.from_numpy(raw).to(cuda)
    mv = torch.tensor([1.0, 1.0, 1.0, 0.0], device=cuda)
    part = repair_partition_torch(shares, shares, shares, dev, mv)
    devs = partition_devices(dev, part, mv)
    db = sample_mixed(rng, len(net), B).to(cuda)
    pairs = pair_tables(t.candidates, pes_hint(board.pes))
    search = _pair_layer_tables(t, pairs)
    seen = []
    for m in range(4):
        lane = lane_devices(devs, m)
        assert isinstance(lane, DeviceTables) and lane.per_row
        seen.append(lane.pes)
        maps = _ce_maps(db, t, lane)
        args = (maps.pes_ce, _search_ce(maps), *search)
        ker = parallelism_search(*args)
        ref = parallelism_search_ref(*args)
        for k, r in zip(ker, ref):
            assert torch.equal(k, r), m
    pes = torch.cat(seen)
    assert float(pes.min()) == math.floor(0.05 * board.pes)
    assert float(pes.max()) == board.pes


def test_deploy_on_card_equals_cpu(cuda):
    """``Session.deploy`` on the card against the CPU port, a guided and
    the random arm: the same designs, shares and front, the metrics within
    1e-5; one search launch per lane of every generation."""
    from repro_torch.core.multinet import MultinetSearchConfig
    nets = [get_cnn("resnet50"), get_cnn("mobilenetv2")]
    card = Session(get_board("zc706"), device=str(cuda))
    cpu = Session(get_board("zc706"), device="cpu")
    for kw in (dict(strategy="hybrid", config=MultinetSearchConfig(
                   pop_size=128, seed=3, objective="slo",
                   slo_s=(0.08, 0.02))),
               dict(strategy="random", seed=1, chunk=128)):
        reset_launches()
        got = card.deploy(nets, 512, **kw)
        n_launch = launches()["parallelism_search"]
        want = cpu.deploy(nets, 512, **kw)
        assert n_launch == 4 * 3, kw       # 4 generations/chunks x 3 lanes
        for g, w in zip(got.designs.to_numpy(), want.designs.to_numpy()):
            np.testing.assert_array_equal(g, w)
        for k, w in want.shares.items():
            np.testing.assert_array_equal(got.shares[k], w)
        np.testing.assert_array_equal(got.front, want.front)
        for k, w in want.metrics.items():
            if k in ("pes_split", "buf_split", "assign"):
                np.testing.assert_array_equal(got.metrics[k], w)
            else:
                np.testing.assert_allclose(got.metrics[k], w, rtol=1e-5,
                                           err_msg=k)


def test_faulted_kernel_under_deploy_is_backend_fault_on_card(cuda):
    from repro_torch.core.multinet import MultinetSearchConfig
    from repro_torch.core.resilience import EvalError
    calls = {"cuda": 0}

    def hook(site, route):
        calls[route] = calls.get(route, 0) + 1
        if route == "cuda":
            raise RuntimeError("injected launch failure")

    nets = [get_cnn("resnet50"), get_cnn("mobilenetv2")]
    ses = Session(get_board("zc706"), device=str(cuda))
    prev = mccm_ops.set_fault_hook(hook)
    try:
        with pytest.raises(EvalError) as e:
            ses.deploy(nets, 128, config=MultinetSearchConfig(pop_size=64))
    finally:
        mccm_ops.set_fault_hook(prev)
    assert e.value.code == EvalError.BACKEND_FAULT
    assert calls == {"cuda": 1} and ses.stats.degraded == 0


def test_server_on_card_reply_equals_evaluate(cuda):
    """The socket server on a card session: a list and a scalar evaluate
    over loopback equal local ``evaluate`` on the card bit for bit (f32
    through JSON), one search launch a chunk."""
    from repro_torch.core.notation import format_spec
    from repro_torch.serve import EvalServer, ServeClient
    net = get_cnn("mobilenetv2")
    notation = [format_spec(make_arch(a, net, n), len(net))
                for a in ARCH_NAMES for n in (2, 5, 9)]
    with Session(get_board("zc706"), device=str(cuda),
                 linger_s=0.005) as ses:
        want = ses.evaluate(notation, net)
        with EvalServer(ses) as srv, ServeClient(*srv.address) as cli:
            reset_launches()
            got = cli.evaluate(notation, "mobilenetv2", timeout_s=300)
            assert launches()["parallelism_search"] == 1
            one = cli.evaluate(notation[0], "mobilenetv2", timeout_s=300)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k], w.dtype), w,
                                      err_msg=k)
        assert one[k] == float(w[0]), k


def test_island_search_on_card_equals_cpu(cuda):
    """The serial island model on the card against the same search on the
    CPU (golden configuration B: 3 islands, the final generation in two
    sub-rounds): the same designs, fronts, island fronts, migrants and
    archive sizes, the metrics within 1e-5; one search launch a step."""
    from repro_torch.core.dse.search import SearchConfig, search
    cfg = SearchConfig(n_islands=3, pop_size=40, budget=530,
                       migration_interval=1, migration_elites=3, seed=5)
    net, board = get_cnn("mobilenetv2"), get_board()
    reset_launches()
    got = search(net, board, cfg, device=str(cuda))
    n_launch = launches()["parallelism_search"]
    want = search(net, board, cfg, device="cpu")
    assert n_launch == 3 * 3 + 3 * 2          # 3 generations + 2 sub-rounds
    for g, w in zip(got.batch.to_numpy(), want.batch.to_numpy()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.front_idx, want.front_idx)
    for g, w in zip(got.island_fronts, want.island_fronts):
        np.testing.assert_array_equal(g, w)
    assert [(h["islands"], h["migrants"]) for h in got.history] == \
        [(h["islands"], h["migrants"]) for h in want.history]
    for k, w in want.metrics.items():
        np.testing.assert_allclose(got.metrics[k], w, rtol=1e-5, err_msg=k)


def _walk_reduced_train_step(device):
    """The walk of one reduced Llama train step in f32 (the chunked path:
    the kernel forward, the Function's backward, remat, a loss chunk of
    12), the batch already on ``device``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import synth_batch, to_device
    from repro_torch.gpu.op_walk import OpWalk
    cfg, api, rt, state, step = _train_setup(device)
    batch = to_device(synth_batch(cfg, ShapeSpec("t", "train", 32, 4), 0),
                      device)
    with OpWalk() as walk:
        step(state, batch)
    return walk.costs()


def test_op_walk_on_card_equals_cpu(cuda):
    """The same step walked on the CPU (the plain flash recurrence, the
    backward on the caller's thread) and on the card (the f32 kernel,
    the backward and remat's recompute on autograd's device thread):
    equal FLOPs, bytes, transcendentals, census and charges, 4
    ``flash_fwd`` charges (2 layers, forward and recompute), each one of
    the card's launches."""
    from repro_torch.kernels import launches, reset_launches
    cpu = _walk_reduced_train_step(torch.device("cpu"))
    reset_launches()
    card = _walk_reduced_train_step(cuda)
    torch.cuda.synchronize()
    assert launches()["flash_fwd"] == 4
    assert card.charges == cpu.charges == {"flash_fwd": 4}
    for f in ("flops", "bytes_accessed", "transcendentals", "census",
              "flops_by_dtype", "bytes_by_op"):
        assert getattr(card, f) == getattr(cpu, f), f


def test_h100_spec_equals_the_card(cuda):
    from repro_torch.gpu.chip import H100
    props = torch.cuda.get_device_properties(cuda)
    assert props.multi_processor_count == H100.sms
    assert props.shared_memory_per_block_optin == H100.smem_bytes_per_block
    assert props.total_memory == H100.hbm_capacity


def _card_meshes(cuda):
    """Four shards of one card, and, with more than one card visible,
    one shard a card over ``min(4, count)`` cards."""
    from repro_torch.core.shard import EvalMesh
    meshes = [EvalMesh(devices=[cuda] * 4)]
    n = torch.cuda.device_count()
    if n > 1:
        meshes.append(EvalMesh(min(4, n)))
    return meshes


def test_sharded_evaluate_batch_on_card_equals_unsharded(cuda):
    """The design-axis mesh on the card: a sharded ``evaluate_batch`` (rows
    padded to 4 x 128, each shard in chunks of 2048) bit-equal to the
    single-device call, every shard launching one search kernel a chunk
    of its rows on its own device."""
    from repro_torch.core.batch_eval import evaluate_batch, padded_rows
    net, board = get_cnn("resnet50"), get_board("zcu102")
    db = sample_mixed(np.random.default_rng(6), len(net), 5000)
    t = make_tables(net, device=cuda)
    want = evaluate_batch(db.to(cuda), t, board)
    for mesh in _card_meshes(cuda):
        got = evaluate_batch(db.to(cuda), t, board, mesh=mesh)
        for k, w in want.items():
            assert got[k].device == mesh.devices[0]
            assert torch.equal(got[k].to(cuda), w), k
        rows = padded_rows(db.batch, 128, mesh.ndevices) // mesh.ndevices
        assert [s["parallelism_search"] for s in mesh.shard_launches] \
            == [-(-rows // 2048)] * mesh.ndevices


def test_sharded_island_search_on_card_equals_serial(cuda):
    """Four islands, one a shard (four shards of one card, then one a card
    where there are several), bit-equal to the serial islands on the
    card: designs, points, metrics, fronts and history."""
    from repro_torch.core.dse.search import SearchConfig, search
    cfg = SearchConfig(n_islands=4, pop_size=64, budget=1300,
                       migration_interval=2, migration_elites=4, seed=3)
    net, board = get_cnn("mobilenetv2"), get_board()
    want = search(net, board, cfg, device=str(cuda))
    for mesh in _card_meshes(cuda):
        if mesh.ndevices != 4:
            continue
        got = search(net, board, cfg, device=str(cuda), mesh=mesh)
        for g, w in zip(got.batch.to_numpy(), want.batch.to_numpy()):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got.points, want.points)
        for k, w in want.metrics.items():
            np.testing.assert_array_equal(got.metrics[k], w, err_msg=k)
        np.testing.assert_array_equal(got.front_idx, want.front_idx)
        assert got.history == want.history
        assert all(s["parallelism_search"] > 0 for s in mesh.shard_launches)


def test_lm_mesh_on_card_meets_golden_and_one_by_one(cuda, tmp_path):
    """The LM mesh with its ranks on this card (gloo on CUDA tensors):
    the golden mesh cases of the 2 x 2 world within
    tests/test_torch_mesh.py's tolerances (loss 1e-5, the rest 5e-5 of
    each leaf's scale, tokens exact, one compressed step within one
    quantum) and its 1 x 4 cases, every golden output run, the reshard
    onto 4 x 1 bit-equal, and the 1 x 1 world's mesh routes bit-equal to
    the unsharded ones."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_check as mesh_check
    ck = str(tmp_path / "ck")
    got = {}
    for world in (4, 1):
        path = str(tmp_path / f"w{world}.npz")
        mesh_check.spawn(world, path, ck, device="cuda")
        with np.load(path) as z:
            got.update({f"{world}/{k}": z[k] for k in z.files})
    g = mesh_check.golden()
    for k, w in g.items():
        if w.dtype.kind in "USO" or "/batch/" in k or "/init/" in k \
                or k.endswith("/moe/x"):
            continue
        assert f"4/{k}" in got, f"{k}: not run on the card"
        a = got[f"4/{k}"]
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(a, w, err_msg=k)
        elif "/compress/grads/" in k or "/compress/residuals/" in k:
            arch, rest = k.split("/compress/")
            path = (rest.split("/", 2)[-1] if rest.startswith("residuals")
                    else rest[len("grads/"):])
            q = np.abs(a - w) / g[f"{arch}/compress/scales/{path}"]
            assert q.max(initial=0.0) <= 1.0 + 1e-3, k
        elif k.endswith("/compress/losses"):
            # one compressed step on the card (the CPU tests hold all 12:
            # each int8 rounding that flips moves the rest of the run)
            np.testing.assert_allclose(a[:1], w[:1], rtol=0, atol=1e-5,
                                       err_msg=k)
        elif k.endswith(("/loss", "/nll", "/aux", "/grad_norm")):
            np.testing.assert_allclose(a, w, rtol=0, atol=1e-5, err_msg=k)
        elif "/scales/" in k:
            np.testing.assert_allclose(a, w, rtol=1e-5, err_msg=k)
        else:
            scale = max(1.0, float(np.abs(w).max(initial=0.0)))
            np.testing.assert_allclose(a, w, rtol=0, atol=5e-5 * scale,
                                       err_msg=k)
    with np.load(f"{ck}/2x2/step_00000001/arrays.npz") as z:
        for k in z.files:
            for world, lab in ((4, "4x1"), (1, "1x1")):
                np.testing.assert_array_equal(
                    got[f"{world}/reshard/{lab}/{k}"].astype(z[k].dtype),
                    z[k], err_msg=k)
    mesh = {k: v for k, v in got.items() if k.startswith("1/one/")
            and "/mesh/" in k and not k.endswith("cache_placements")}
    assert mesh
    for k, v in mesh.items():
        np.testing.assert_array_equal(v, got[k.replace("/mesh/", "/plain/")],
                                      err_msg=k)
