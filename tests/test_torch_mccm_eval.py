"""The port's MCCM evaluation kernels (``repro_torch.kernels.mccm_eval``)
against the JAX package's, on the CPU.

The parallelism search: the same inputs, built by the JAX package from the
baseline templates, go through the JAX plain reference and the port's
plain version (the route a CPU tensor takes).  ⟨pf, ph, pw⟩ must be
exactly equal; the cost within rtol 1e-6 (it is equal bit for bit today:
both sum the layers in ascending order), with inf where the reference has
inf.

The Eq. 1 latency sweep: the port's plain version against the JAX Pallas
kernel (interpret mode) and its reference at ``tests/test_kernels.py``'s
shapes, rtol 1e-6 (the per-layer cycles are equal; the totals may differ
in the last bits, the JAX sum having its own order), and against the
batch path's own ``layer_state`` cycles bit for bit.

The search kernel's launch plan (``ops.search_plan``) and the latency
kernel's (``ops.latency_plan``) are plain Python and are held here to the
card's limits, the search's at every (B, L, P) the batch path can
produce, and the plain version to the facts the kernel's design rests on:
a CE that owns no layer takes its first feasible pair at cost 0, a CE with
0 PEs takes pair 0 at inf, ties go to the first pair.

The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.registry import get_cnn as jax_get_cnn
from repro.core.batch_eval import (_ce_maps as jax_ce_maps,
                                   _pair_layer_tables as jax_pair_layer_tables,
                                   encode_specs as jax_encode_specs,
                                   make_device_tables as jax_make_device_tables,
                                   make_tables as jax_make_tables, pes_hint)
from repro.core.blocks import CANDIDATES_DEFAULT
from repro.fpga.archs import ARCH_NAMES, make_arch
from repro.fpga.boards import get_board as jax_get_board
from repro.kernels.mccm_eval import pair_tables as jax_pair_tables
from repro.kernels.mccm_eval import parallelism_search as jax_search
from repro.kernels.mccm_eval.ops import mccm_latency as jax_mccm_latency
from repro.kernels.mccm_eval.ref import \
    mccm_latency_ref as jax_mccm_latency_ref
from repro.kernels.mccm_eval.kernel import \
    parallelism_search_call as jax_search_call
from repro.kernels.mccm_eval.ref import \
    parallelism_search_ref as jax_search_ref
from repro_torch.kernels import _nvcc
from repro_torch.kernels.mccm_eval import (launches, mccm_latency,
                                           mccm_latency_cuda,
                                           mccm_latency_ref, pair_tables,
                                           parallelism_search,
                                           parallelism_search_cuda,
                                           reset_launches, search_plan,
                                           set_fault_hook)
from repro_torch.kernels.mccm_eval import ops as mccm_ops
from torch_search_cases import (ascending_sum, give_absent_ces_pes,
                                latency_nonfinite_inputs,
                                latency_order_inputs, port_inputs,
                                synthetic_net, tie_inputs, tree_sum)

RTOL_COST = 1e-6


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jax_search_inputs(cnn, board="vcu110"):
    """The JAX package's search inputs for the 12 baseline templates
    (``tests/test_kernels.py::_search_inputs``) and its reference's
    outputs, with the inputs as the port's search arguments: the CE index
    of each layer read off the JAX one-hot (-1 for a zero row), the raw
    ``OW`` column, and the pair list as CPU tensors."""
    net, dev = jax_get_cnn(cnn), jax_get_board(board)
    specs = [make_arch(a, net, n) for a in ARCH_NAMES for n in (2, 5, 9, 11)]
    tables = jax_make_tables(net)
    maps = jax_ce_maps(jax_encode_specs(specs, len(net)), tables,
                       jax_make_device_tables(dev))
    pairs = jax_pair_tables(tables.candidates, pes_hint(dev.pes))
    fc, coh = jax_pair_layer_tables(tables, pairs)
    ref = jax_search(maps.pes_ce, maps.ce_of_layer, maps.ce_oh, fc, coh,
                     tables.CEIL_OW, tables.OW[:, None], pairs,
                     backend="ref")
    ceoh = np.asarray(maps.ce_oh)
    ce_idx = np.where(ceoh.any(-1), ceoh.argmax(-1), -1)
    args = [_t(maps.pes_ce), _t(ce_idx, torch.int32), _t(fc), _t(coh),
            _t(tables.OW), _t(pairs.cand), _t(pairs.pair_prod),
            _t(pairs.pair_pf), _t(pairs.pair_ph)]
    return args, [np.asarray(r) for r in ref]


def _assert_search_equal(got, want, label):
    for name, g, w in zip(("pf", "ph", "pw"), got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{label} {name}")
    g, w = got[3].numpy(), want[3]
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w),
                                  err_msg=f"{label} cost inf")
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL_COST,
                               err_msg=f"{label} cost")


@pytest.mark.parametrize("hint", [None, 900, 2520, 8192])
def test_pair_tables_equal_jax(hint):
    got = pair_tables(CANDIDATES_DEFAULT, hint)
    want = jax_pair_tables(CANDIDATES_DEFAULT, hint)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("cnn", ["resnet50", "xception", "mobilenetv2",
                                 "densenet121", "resnet152"])
def test_plain_search_matches_jax_ref(cnn):
    args, want = _jax_search_inputs(cnn)
    _assert_search_equal(parallelism_search(*args), want, cnn)


def test_plain_search_infeasible_ce_degrades_to_unit():
    """A CE with 0 PEs (no layers) selects ⟨1, 1, 1⟩ at cost inf."""
    args, _ = _jax_search_inputs("mobilenetv2", "zc706")
    L = args[1].shape[1]
    args[:2] = torch.zeros(2, 16), torch.full((2, L), -1, dtype=torch.int32)
    pf, ph, pw, cost = parallelism_search(*args)
    assert (pf == 1).all() and (ph == 1).all() and (pw == 1).all()
    assert torch.isinf(cost).all()


def test_cpu_route_launches_no_kernel():
    args, _ = _jax_search_inputs("mobilenetv2")
    reset_launches()
    parallelism_search(*args)
    assert launches()["parallelism_search"] == 0
    assert not any(launches().values())


def test_tensor_on_another_device_raises():
    """Only a CPU tensor takes the plain version; any other device that is
    not CUDA raises instead of falling back."""
    pes = torch.zeros(2, 16, device="meta")
    with pytest.raises(ValueError, match="no parallelism_search route"):
        parallelism_search(pes, *[None] * 8)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper checks its inputs before any build or launch."""
    args, _ = _jax_search_inputs("mobilenetv2")
    with pytest.raises(ValueError, match="one CUDA device"):
        parallelism_search_cuda(*args)
    assert launches()["parallelism_search"] == 0


def test_fault_hook_seam():
    seen = []

    def hook(name, route):
        seen.append((name, route))
        raise RuntimeError("injected")

    prev = set_fault_hook(hook)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            parallelism_search(torch.zeros(1, 16), *[None] * 8)
    finally:
        assert set_fault_hook(prev) is hook
    assert seen == [("parallelism_search", "ref")]


def test_kernel_build_flags():
    """The kernel is built for sm_90a, never with fast math (ceil(x/p)
    needs the correctly rounded quotient), and under the checkout."""
    flags = " ".join(_nvcc.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "--fmad=false" in flags
    assert _nvcc.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


# ------------------------------------------------- the search kernel's plan
def _plan_shapes():
    """(P, K) of every pair list the batch path builds: each board's own
    pruning bucket, every bucket of the ladder, and no pruning."""
    from repro_torch.core.batch_eval import PES_HINTS
    from repro_torch.core.batch_eval import pes_hint as torch_pes_hint
    from repro_torch.fpga.boards import BOARD_NAMES, get_board
    hints = {torch_pes_hint(get_board(b).pes) for b in BOARD_NAMES}
    hints |= set(PES_HINTS) | {None}
    return sorted({(len(pair_tables(CANDIDATES_DEFAULT, h).pair_prod),
                    len(CANDIDATES_DEFAULT)) for h in hints})


def _assert_plan_runs(plan, B, L, P, K):
    """The limits the entry point checks, and a grid that covers the batch
    with no block left idle."""
    assert plan.smem_bytes == mccm_ops.search_smem(plan.staged_rows, P, K)
    assert plan.smem_bytes <= mccm_ops.MAX_SMEM
    assert 0 <= plan.staged_rows <= L
    # as many rows staged as fit
    if plan.staged_rows < L:
        assert mccm_ops.search_smem(plan.staged_rows + 1, P, K) \
            > mccm_ops.MAX_SMEM
    assert 1 <= plan.warps <= mccm_ops.MAX_WARPS
    assert plan.npl in mccm_ops.NPLS
    assert plan.npl == next((n for n in mccm_ops.NPLS if 32 * n >= P),
                            mccm_ops.NPL_MAX)
    assert plan.pair_groups * 32 * plan.npl >= P \
        > (plan.pair_groups - 1) * 32 * plan.npl
    assert plan.designs_per_block % plan.warps == 0
    assert plan.blocks * plan.designs_per_block >= B
    # a block strides over slots of ``warps`` designs: none is left idle
    assert 1 <= plan.blocks <= -(-B // plan.warps)
    resident = mccm_ops.SM_SMEM // (plan.smem_bytes
                                    + mccm_ops.SMEM_PER_BLOCK)
    assert resident >= 1
    assert plan.blocks <= mccm_ops.SMS * min(
        resident, mccm_ops.SM_WARPS // plan.warps)


@pytest.mark.parametrize("cnn", ["resnet50", "resnet152", "vgg16",
                                 "mobilenetv2", "xception", "densenet121",
                                 "resnet101", "densenet264"])
def test_search_plan_fits_the_card(cnn):
    """For every CNN, at its padded L and at every L up to 256 the bucket
    ladder gives, and every pair list of a board, a bucket or none: the
    plan fits the card, and every net padded to 160 layers is staged
    whole."""
    from repro_torch.cnn.registry import get_cnn
    from repro_torch.core.batch_eval import bucket_max_L
    L0 = bucket_max_L(len(get_cnn(cnn)))
    for P, K in _plan_shapes():
        for L in (L0, 192, 224, 256):
            for B in (1, 17, 1024, 2047, 2048, 100_000):
                plan = search_plan(B, L, P, K)
                _assert_plan_runs(plan, B, L, P, K)
                if L == 160:
                    assert plan.staged_rows == L, (P, plan)
    # the main path's chunk: one design a warp, one wave of blocks
    plan = search_plan(2048, L0, 219, 18)
    assert (plan.warps, plan.blocks, plan.designs_per_block) == (16, 128, 16)
    assert plan.staged_rows == min(L0, 241) and plan.pair_groups == 1


def test_search_plan_at_densenet264_on_the_zcu102():
    """DenseNet-264 pads to 288 rows; at the ZCU102's 219 pairs and 18
    candidates a block stages 241 of them in 231,928 of its 232,448
    shared-memory bytes, so its last 23 live rows are read from L2, at
    the bulk cell's 100,000 designs as at the default chunk."""
    from repro_torch.cnn.registry import get_cnn
    from repro_torch.core.batch_eval import bucket_max_L
    L = len(get_cnn("densenet264"))
    assert bucket_max_L(L) == 288
    for B in (2048, 100_000):
        plan = search_plan(B, 288, 219, 18)
        _assert_plan_runs(plan, B, 288, 219, 18)
        assert (plan.staged_rows, plan.smem_bytes) == (241, 231_928)
        assert L - plan.staged_rows == 23
        assert mccm_ops.MAX_SMEM - plan.smem_bytes < 4 * (219 + 18)


@pytest.mark.parametrize("P", [1, 31, 33, 384, 385, 1000])
def test_search_plan_takes_every_shape(P):
    """No shape the plain version takes is refused: long pair lists walk
    in groups, and layers past the shared memory are read from L2."""
    for L in (1, 53, 4096):
        for K in (1, 18, 40):
            for B in (1, 5000):
                _assert_plan_runs(search_plan(B, L, P, K), B, L, P, K)
    with pytest.raises(ValueError, match="B, L, P, K >= 1"):
        search_plan(0, 160, P, 18)


def test_search_constants_match_the_kernel_source():
    src = mccm_ops.SOURCE.read_text()
    for name, value in (("NPL_MAX", mccm_ops.NPL_MAX),
                        ("MAX_WARPS", mccm_ops.MAX_WARPS),
                        ("MAX_SMEM", mccm_ops.MAX_SMEM),
                        ("LUT_N", mccm_ops.LUT_N),
                        ("NC", mccm_ops.NC)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert re.search(r"constexpr int SLACK = 32 \* NPL_MAX;", src)
    assert mccm_ops.SLACK == 32 * mccm_ops.NPL_MAX
    npls = tuple(int(n) for n in re.search(
        r"constexpr int NPLS\[\] = \{([\d, ]+)\};", src)[1].split(","))
    assert npls == mccm_ops.NPLS and npls[-1] == mccm_ops.NPL_MAX
    kernels = src.split("const Kernel KERNELS[] =")[1].split(";")[0]
    assert tuple(int(n) for n in re.findall(
        r"parallelism_search_kernel<(\d+)>", kernels)) == npls


def test_search_instantiations_are_the_batch_paths():
    """Each pair list the batch path builds runs in one group at exactly
    ceil(P/32) pairs a lane, and each instantiation serves one of them."""
    shapes = _plan_shapes()
    assert [P for P, _ in shapes] == [219, 264, 312, 324]
    used = {search_plan(2048, 160, P, K).npl for P, K in shapes}
    assert used == set(mccm_ops.NPLS)
    for P, K in shapes:
        plan = search_plan(2048, 160, P, K)
        assert plan.npl == -(-P // 32) and plan.pair_groups == 1


def _jax_on(args):
    """The JAX plain reference and Pallas kernel (interpret mode) on the
    port's search arguments; both results as numpy arrays."""
    pes, ce, fc, coh, ow, cand, prod, pf, ph = (np.asarray(a) for a in args)
    ce_oh = (ce[..., None] == np.arange(16)).astype(np.float32)
    ceil_ow = np.ceil(ow[:, None] / cand[None, :]).astype(np.float32)
    ref = jax_search_ref(pes, np.clip(ce, 0, 15), ce_oh, fc, coh, ceil_ow,
                         cand, prod, pf, ph)
    ker = jax_search_call(pes, ce_oh, fc, coh, ow[:, None], cand, prod, pf,
                          ph, design_tile=8, interpret=True)
    return [np.asarray(r) for r in ref], [np.asarray(k) for k in ker]


def _assert_equal_to_jax(args, label):
    got = [g.numpy() for g in parallelism_search(*args)]
    for want in _jax_on(args):
        for name, g, w in zip(("pf", "ph", "pw", "cost"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")
    return got


@pytest.mark.parametrize("n_layers,pes", [(53, 100_000), (180, 2520),
                                          (180, 100_000), (264, 2520)])
def test_plain_search_matches_jax_past_the_ladder(n_layers, pes):
    """A board beyond the PES_HINTS ladder (no pruning: P = 324), a net
    padded to L = 192 and DenseNet-264 at L = 288: the port's plain
    version equals the JAX reference and the Pallas kernel bit for bit."""
    from repro_torch.cnn.registry import get_cnn
    net = {53: get_cnn("resnet50"), 264: get_cnn("densenet264")}.get(
        n_layers) or synthetic_net(n_layers)
    args = port_inputs(net, pes, 24, n_layers)
    assert args[2].shape[1] == (324 if pes > 65536 else 219)
    assert args[1].shape[1] == {53: 160, 180: 192, 264: 288}[n_layers]
    _assert_equal_to_jax(args, f"{n_layers}/{pes}")


def test_plain_search_ce_without_layers_takes_first_feasible_pair():
    """What lets the kernel skip the walk for a CE that owns no layer:
    every feasible pair costs 0, so the first feasible pair wins, at cost
    0, with that pair's pw; with none feasible, pair 0 at inf."""
    from repro_torch.cnn.registry import get_cnn
    args = port_inputs(get_cnn("resnet50"), 2520, 32, 5)
    absent = give_absent_ces_pes(args, 6)
    pes = args[0]
    pf, ph, pw, cost = _assert_equal_to_jax(args, "absent CEs")
    cand, prod = args[5].numpy(), args[6].numpy()
    for b, c in zip(*np.nonzero(absent.numpy())):
        q = np.float32(pes[b, c]) / prod
        feas = np.nonzero(q >= 1)[0]
        p = feas[0] if feas.size else 0
        assert (pf[b, c], ph[b, c]) == (args[7][p], args[8][p])
        assert cost[b, c] == (0.0 if feas.size else np.inf)
        k = max(np.searchsorted(cand, np.floor(q[p]), side="right") - 1, 0)
        assert pw[b, c] == cand[k]


def test_plain_search_zero_pe_ce_is_infeasible_everywhere():
    """A CE with 0 PEs, with layers or without, takes pair 0 at inf: 0/x
    is never >= 1, whatever the pair list."""
    from repro_torch.cnn.registry import get_cnn
    args = port_inputs(get_cnn("mobilenetv2"), 2520, 16, 7)
    args[0] = args[0].clone()
    args[0][:, ::3] = 0.0            # CEs 0, 3, 6, ...: most own layers
    pf, ph, pw, cost = _assert_equal_to_jax(args, "zero PEs")
    assert np.isinf(cost[:, ::3]).all()
    assert (pf[:, ::3] == args[7][0].item()).all()
    assert (ph[:, ::3] == args[8][0].item()).all()
    assert (pw[:, ::3] == args[5][0].item()).all()


def test_plain_search_ties_go_to_the_first_pair():
    args = tie_inputs()
    pf, ph, pw, cost = _assert_equal_to_jax(args, "ties")
    fin = np.isfinite(cost)
    assert fin.any() and (~fin).any()
    # the winner is the first of the 7 residues: one of pairs 0..6
    best = np.array([[np.flatnonzero((args[7].numpy() == pf[b, c])
                                     & (args[8].numpy() == ph[b, c]))[0]
                      for c in range(16)] for b in range(pf.shape[0])])
    assert (best < 7).all()


# ------------------------------------------------------------ mccm_latency
@pytest.mark.parametrize("B,L,blk", [(7, 53, 8), (64, 155, 64),
                                     (130, 74, 32)])
def test_mccm_latency_matches_jax(B, L, blk):
    """``tests/test_kernels.py:78``'s shapes and inputs: the port's plain
    version against the JAX Pallas kernel (interpret) and its reference."""
    rng = np.random.default_rng(0)
    dims = rng.integers(1, 512, (L, 4)).astype(np.float32)
    par = rng.choice([1, 2, 4, 8, 16, 32], (B, L, 3)).astype(np.float32)
    tot, cyc = mccm_latency(torch.from_numpy(dims), torch.from_numpy(par))
    assert tot.shape == (B,) and cyc.shape == (B, L)
    for want_tot, want_cyc in (
            jax_mccm_latency(jnp.asarray(dims), jnp.asarray(par),
                             design_blk=blk),
            jax_mccm_latency_ref(jnp.asarray(dims), jnp.asarray(par))):
        np.testing.assert_allclose(cyc.numpy(), np.asarray(want_cyc),
                                   rtol=1e-6)
        np.testing.assert_allclose(tot.numpy(), np.asarray(want_tot),
                                   rtol=1e-6)
    # the total adds the layers left to right
    acc = cyc[:, 0].clone()
    for l in range(1, L):
        acc += cyc[:, l]
    assert torch.equal(tot, acc)


@pytest.mark.parametrize("cnn", ["resnet50", "mobilenetv2"])
def test_mccm_latency_equals_layer_state(cnn):
    """Per-layer ⟨pf, ph, pw⟩ from the batch path's own search, masked to
    1 off the valid layers as ``layer_state`` does: the plain version's
    cycles equal ``layer_state(...).comp`` bit for bit."""
    from repro_torch.cnn.registry import get_cnn
    from repro_torch.core import batch_eval as tbe
    from repro_torch.core.dse import sample_mixed
    from repro_torch.fpga.boards import get_board
    net, board = get_cnn(cnn), get_board("zcu102")
    t = tbe.make_tables(net, device="cpu")
    dt = tbe.make_device_tables(board, device="cpu")
    db = sample_mixed(np.random.default_rng(11), len(net), 48)
    search = tbe._pair_layer_tables(
        t, pair_tables(t.candidates, tbe.pes_hint(board.pes)))
    m = tbe._ce_maps(db, t, dt)
    pf, ph, pw, _ = parallelism_search(m.pes_ce, tbe._search_ce(m), *search)
    par = torch.stack([torch.where(m.valid_b, tbe._per_layer(x, m), 1.0)
                       for x in (pf, ph, pw)], -1)
    dims = torch.stack([t.F, t.CKK, t.OH, t.OW], 1)
    tot, cyc = mccm_latency(dims, par)
    st = tbe.layer_state(db, t, dt, m, (pf, ph, pw), 2)
    assert torch.equal(cyc, st.comp)
    assert torch.equal(cyc[:, t.L:], torch.zeros_like(cyc[:, t.L:]))
    assert torch.equal(tot, mccm_latency_ref(dims, par)[0])


def test_mccm_latency_routes():
    dims, par = torch.ones(5, 4), torch.ones(3, 5, 3)
    reset_launches()
    mccm_latency(dims, par)
    assert not any(launches().values())
    with pytest.raises(ValueError, match="no mccm_latency route"):
        mccm_latency(dims.to("meta"), par.to("meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        mccm_latency_cuda(dims, par)
    assert launches()["mccm_latency"] == 0


@pytest.mark.parametrize("kind", ["zero", "inf", "nan"])
def test_mccm_latency_nonfinite_matches_jax(kind):
    """Zeros, infinities and NaNs in par (and zeros in dims) reach the
    same cycles, inf and NaN in the same places, as in the JAX Pallas
    kernel (interpret) and its reference; the totals within rtol 1e-6
    (the JAX sum has its own order), inf and NaN in the same places."""
    dims, par = latency_nonfinite_inputs(kind)
    tot, cyc = mccm_latency(torch.from_numpy(dims), torch.from_numpy(par))
    assert not np.isfinite(cyc.numpy()).all()
    for want_tot, want_cyc in (
            jax_mccm_latency(jnp.asarray(dims), jnp.asarray(par),
                             design_blk=8),
            jax_mccm_latency_ref(jnp.asarray(dims), jnp.asarray(par))):
        np.testing.assert_array_equal(cyc.numpy(), np.asarray(want_cyc))
        np.testing.assert_allclose(tot.numpy(), np.asarray(want_tot),
                                   rtol=1e-6, equal_nan=True)


def test_mccm_latency_total_adds_in_ascending_order():
    """A total that the order of the sum decides: the plain version's
    equals the layers added left to right in f32, and differs from a
    pairwise (tree) sum of the same cycles, so a kernel that reorders its
    sum fails the card's equality with the plain version."""
    dims, par = latency_order_inputs()
    tot, cyc = mccm_latency(torch.from_numpy(dims), torch.from_numpy(par))
    np.testing.assert_array_equal(tot.numpy(), ascending_sum(cyc.numpy()))
    assert (tot.numpy() != tree_sum(cyc.numpy())).all()
    assert (tot.numpy() != cyc.numpy().astype(np.float64).sum(1)).all()


# ------------------------------------------------ the latency kernel's plan
@pytest.mark.parametrize("L", [1, 53, 160, mccm_ops.LATENCY_MAX_L])
@pytest.mark.parametrize("B", [1, 63, 2048, 100_000])
def test_latency_plan_fits_the_card(B, L):
    """The plan the library computes, mirrored: shared memory within a
    block's limit, as many blocks an SM as its shared memory and threads
    allow, tiles of at least one design (at most one a consumer thread,
    T·L a multiple of 4), a grid no larger than the tiles or the resident
    blocks, and a batch of few designs spread over the SMs."""
    o = mccm_ops
    plan = o.latency_plan(B, L)
    assert plan.threads == o.LAT_THREADS and plan.stages == o.LAT_STAGES
    assert plan.smem_bytes == o.latency_smem(L, plan.tile) <= o.MAX_SMEM
    assert 1 <= plan.tile <= o.LAT_CONSUMERS and plan.tile * L % 4 == 0
    bps = plan.blocks_per_sm
    assert 1 <= bps <= o.SM_BLOCKS
    assert bps * (plan.smem_bytes + o.SMEM_PER_BLOCK) <= o.SM_SMEM
    assert bps * plan.threads <= o.SM_THREADS
    assert bps == o.SM_BLOCKS or (bps + 1) * plan.threads > o.SM_THREADS \
        or (bps + 1) * (plan.smem_bytes + o.SMEM_PER_BLOCK) > o.SM_SMEM
    tiles = -(-B // plan.tile)
    assert 1 <= plan.grid == min(tiles, o.SMS * bps)
    # the tile is the least that needs no more rounds of the grid
    rounds = -(-tiles // plan.grid)
    q = 4 // np.gcd(L, 4)
    if plan.tile > q:
        assert -(-B // (plan.tile - q)) > rounds * plan.grid
    if B >= o.SMS * 4:
        assert plan.grid >= o.SMS


def test_latency_plan_refuses_what_the_kernel_refuses():
    for B, L in ((0, 160), (5, 0), (5, mccm_ops.LATENCY_MAX_L + 1)):
        with pytest.raises(ValueError, match="latency kernel takes"):
            mccm_ops.latency_plan(B, L)


def test_latency_plan_at_the_smoke_shapes():
    """The plans ``chip_smoke.py`` phase 6 runs: ResNet-50 padded to 160
    layers and unpadded (53), at 100,000 designs, and one 2048-design
    chunk.  At 160 layers the shared memory holds 274 designs' rows, three
    rounds of 132 blocks, so the tile is the least that keeps three: 253,
    exactly three tiles a block."""
    o = mccm_ops
    assert o.latency_smem(160, 274) <= o.MAX_SMEM < o.latency_smem(160, 275)
    p = o.latency_plan(100_000, 160)
    assert (p.tile, p.blocks_per_sm, p.grid) == (253, 1, 132)
    assert -(-100_000 // p.tile) == 3 * p.grid
    p = o.latency_plan(100_000, 53)
    assert (p.tile, p.blocks_per_sm, p.grid) == (380, 1, 132)
    p = o.latency_plan(2048, 160)
    assert p.grid >= o.SMS and p.tile == 6


def test_latency_constants_match_the_kernel_source():
    src = mccm_ops.LATENCY_SOURCE.read_text()
    o = mccm_ops
    for name, value in (("NT", o.LAT_CONSUMERS), ("STAGES", o.LAT_STAGES),
                        ("MAX_L", o.LATENCY_MAX_L), ("MAX_SMEM", o.MAX_SMEM),
                        ("SM_SMEM", o.SM_SMEM),
                        ("SMEM_PER_BLOCK", o.SMEM_PER_BLOCK),
                        ("SMS", o.SMS), ("SM_THREADS", o.SM_THREADS),
                        ("SM_BLOCKS", o.SM_BLOCKS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert re.search(rf"constexpr int STEPS = {o.LAT_STEPS};", src)
    assert re.search(r"constexpr int THREADS = NT \+ 32;", src)
    assert re.search(r"constexpr int CHUNK = STEPS \* NT;", src)
    assert o.LAT_THREADS == o.LAT_CONSUMERS + 32
    assert o.LAT_CHUNK == o.LAT_STEPS * o.LAT_CONSUMERS
    assert re.search(r"constexpr int PAR_STAGE = 12 \* CHUNK \+ 16;", src)
    assert re.search(r"constexpr int RING = 16 \* STAGES \+ STAGES \* "
                     r"PAR_STAGE \+ 4 \* CHUNK;", src)
    assert o.LAT_RING == (16 * o.LAT_STAGES
                          + o.LAT_STAGES * (12 * o.LAT_CHUNK + 16)
                          + 4 * o.LAT_CHUNK)
    # the refusals the wrapper names
    for code in o._LATENCY_REFUSALS:
        assert f"return {code};" in src
