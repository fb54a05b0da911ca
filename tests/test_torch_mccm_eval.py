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

The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

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
from repro_torch.kernels import _nvcc
from repro_torch.kernels.mccm_eval import (launches, mccm_latency,
                                           mccm_latency_cuda,
                                           mccm_latency_ref, pair_tables,
                                           parallelism_search,
                                           parallelism_search_cuda,
                                           reset_launches, set_fault_hook)

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
