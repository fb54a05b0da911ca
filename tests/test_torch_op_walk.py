"""The port's op walk (``repro_torch.gpu.op_walk``) on the CPU: exact on a
hand-countable program, the hand kernels charged by formula, charges from
another thread, a reduced Llama prefill and collectives on a gloo group.

The JAX walker's own tests (``tests/test_hlo_walk.py``) hold it on a
scanned ``tanh(x @ w[i])``; here the same program runs eagerly, and the
walk is held to the products autograd runs.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.utils._python_dispatch import _pop_mode, _push_mode

from repro_torch.configs import get_config
from repro_torch.gpu.op_stats import collective_stats, fusion_count, op_census
from repro_torch.gpu.op_walk import OpWalk, charge
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.flash_attn.ops import cost as flash_cost
from repro_torch.kernels.flash_attn.ref import attention_mask
from repro_torch.models import layers as L
from repro_torch.models.registry import get_model
from repro_torch.models.runtime import Runtime
from torch_threads import one_torch_thread  # noqa: F401

N_LAYERS, B, D = 6, 8, 64
#: one (8, 64) x (64, 64) product
ONE_DOT = 2 * B * D * D


def _scan_program(remat: bool):
    """6 layers of tanh(x @ w[i]) on bf16, the gradient of sum(x**2) for
    w; x needs no gradient.  Returns the finished walk."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(N_LAYERS, D, D, generator=gen).to(torch.bfloat16)
    w.requires_grad_(True)
    x = torch.randn(B, D, generator=gen).to(torch.bfloat16)

    def f(x):
        for i in range(N_LAYERS):
            def body(x, i=i):
                return torch.tanh(x @ w[i])
            x = L.checkpoint(body, x) if remat else body(x)
        return (x.float() ** 2).sum()
    with OpWalk() as walk:
        torch.autograd.grad(f(x), w)
    return walk.costs()


def test_flops_are_the_products_autograd_runs():
    """Autograd runs 17 products: 6 forward, 6 for w's gradient and 5 for
    the gradient of each layer's input but the first's (x needs none).
    The JAX walker's scan counts 18 (its transposed body computes both
    gradients in every iteration)."""
    costs = _scan_program(remat=False)
    assert costs.flops == 17 * ONE_DOT
    assert costs.flops_by_dtype == {"bfloat16": 17 * ONE_DOT}
    assert costs.census["aten.mm"] == 17
    assert costs.charges == {}


def test_remat_adds_the_forward_products_and_tanh():
    plain, remat = _scan_program(False), _scan_program(True)
    assert remat.flops - plain.flops == N_LAYERS * ONE_DOT
    assert remat.transcendentals - plain.transcendentals == N_LAYERS * B * D
    assert remat.census["aten.mm"] == 17 + N_LAYERS


def test_bytes_use_slice_sizes_not_buffers():
    """Each product reads a (64, 64) slice of the (6, 64, 64) stack, and
    an (8, 64) operand, and writes (8, 64) or (64, 64): 2 bytes an element
    of the slices, never the stack."""
    costs = _scan_program(remat=False)
    per_dot = 2 * (B * D + D * D + B * D)
    assert costs.bytes_by_op["aten.mm"] == 17 * per_dot
    # views and metadata ops pay nothing
    assert "aten.select" in costs.census
    assert "aten.select" not in costs.bytes_by_op


def _pairs(Sq, Sk, causal, window, q_offset):
    """Visible pairs of one (batch, head), from the plain version's own
    mask."""
    mask = attention_mask(torch.arange(Sq) + q_offset, torch.arange(Sk), Sk,
                          causal, window)
    return int(mask.sum())


@pytest.mark.parametrize("Bq,Sq,Sk,H,Hkv,Dh,causal,window,q_offset", [
    (2, 40, 40, 4, 4, 16, True, None, 0),       # causal self-attention
    (1, 64, 64, 4, 2, 32, True, 9, 0),          # window, GQA
    (2, 8, 50, 4, 1, 16, True, None, 42),       # q_offset, Sq != Sk
    (1, 24, 70, 8, 2, 16, False, None, 0),      # non-causal, Sq != Sk
    (1, 16, 48, 2, 2, 16, True, 5, 20),         # all of them
])
def test_flash_attention_is_charged_its_formula(Bq, Sq, Sk, H, Hkv, Dh,
                                                causal, window, q_offset):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(Bq, Sq, H, Dh, generator=gen)
    k = torch.randn(Bq, Sk, Hkv, Dh, generator=gen)
    v = torch.randn(Bq, Sk, Hkv, Dh, generator=gen)
    with OpWalk() as walk:
        flash_attention(q, k, v, causal=causal, window=window,
                        q_offset=q_offset)
    costs = walk.costs()
    pairs = _pairs(Sq, Sk, causal, window, q_offset) * Bq * H
    assert costs.flops == 4 * Dh * pairs
    assert costs.transcendentals == pairs
    assert costs.bytes_accessed == 4 * (2 * Bq * Sq * H * Dh
                                        + 2 * Bq * Sk * Hkv * Dh)
    assert costs.flops_by_dtype == {"float32": 4 * Dh * pairs}
    assert costs.charges == {"flash_fwd": 1} and fusion_count(walk) == 1
    # none of flash_fwd_ref's ops is counted
    assert costs.census == {} and op_census(walk) == []


def test_visible_pairs_counts_the_mask_at_full_width():
    """The closed count at Llama's training length, against the plain
    version's (S, S) mask: causal, and a window of 1,000."""
    for window in (None, 1000):
        want = _pairs(4096, 4096, True, window, 0)
        got = flash_cost(1, 4096, 4096, 1, 1, 64, True, window,
                         torch.bfloat16)
        assert got["pairs"] == want
        assert got["bytes"] == 2 * (2 * 4096 * 64 + 2 * 4096 * 64)


def test_charge_outside_a_walk_does_nothing():
    def cost():
        raise AssertionError("a cost computed outside a walk")
    with charge("flash_fwd", cost):
        pass


def test_charge_from_a_second_thread_counts():
    """Autograd runs a CUDA step's backward, and remat's recompute, on its
    device thread, carrying the dispatch-mode stack there.  A thread given
    the walk's mode stack the same way is charged, and the plain version's
    ops it runs are not counted, while the first thread's ops are."""
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 32, 2, 16, generator=gen) for _ in range(3))
    a, b = q[0, :, 0], k[0, :, 0].T.contiguous()
    errors = []

    def worker(walk):
        _push_mode(walk)
        try:
            flash_attention(q, k, v)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)
        finally:
            _pop_mode()
    with OpWalk() as walk:
        t = threading.Thread(target=worker, args=(walk,))
        t.start()
        t.join(timeout=60)
        torch.mm(a, b)
    assert not t.is_alive() and not errors
    costs = walk.costs()
    assert costs.charges == {"flash_fwd": 1}
    assert costs.census == {"aten.mm": 1}
    assert costs.flops == 4 * 16 * _pairs(32, 32, True, None, 0) * 2 \
        + 2 * 32 * 16 * 32


def test_reduced_llama_prefill_flops():
    """A prefill's FLOPs: each layer's projections (2·T·d_in·d_out for q,
    k, v, o and SwiGLU's three), the attention's formula (the chunked
    path: the kernel's charge), and the head on the last position."""
    cfg = get_config("llama3.2-1b").reduced().replace(dtype="float32")
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    Bp, S = 2, 40
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (Bp, S)))
    with OpWalk() as walk:
        api.prefill(model, tokens, Runtime(attn_mode="chunked"))
    T, d, hd = Bp * S, cfg.d_model, cfg.head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    proj = (2 * T * d * (H + 2 * Hkv) * hd + 2 * T * H * hd * d
            + 3 * 2 * T * d * cfg.d_ff)
    attn = flash_cost(Bp, S, S, H, Hkv, hd, True, None,
                      torch.float32)["flops"]
    head = 2 * Bp * d * cfg.padded_vocab
    assert walk.costs().flops == cfg.n_layers * (proj + attn) + head
    assert fusion_count(walk) == cfg.n_layers


def test_collectives_on_a_gloo_group_of_one():
    """An all_reduce and an all_gather (torch.distributed's, the c10d
    ops) and a functional all_reduce on a group of one process: counted
    with their operand bytes, and no wire bytes (a group of one moves
    nothing)."""
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        t = torch.ones(4, 3)
        out = [torch.empty(4, 3)]
        with OpWalk() as walk:
            dist.all_reduce(t)
            dist.all_gather(out, t)
            funcol.all_reduce(t, "sum", dist.group.WORLD).add_(1)
        costs = walk.costs()
        stats = collective_stats(walk)
    finally:
        dist.destroy_process_group()
    nbytes = 4 * 3 * 4
    assert costs.coll_count == {"all-reduce": 2, "all-gather": 1}
    assert costs.coll_operand == {"all-reduce": 2 * nbytes,
                                  "all-gather": nbytes}
    assert costs.coll_wire == {"all-reduce": 0.0, "all-gather": 0.0}
    assert costs.total_wire == 0.0
    assert stats.counts == {"all-reduce": 2, "all-gather": 1}
    assert stats.total_operand == 3 * nbytes and stats.total_wire == 0
    d = costs.as_dict()
    assert d["collective_counts"] == costs.coll_count
    assert d["total_wire_bytes"] == 0.0
