"""The port's SSM and hybrid families (``models/ssm.py``,
``models/ssm_lm.py``) on the CPU against the JAX package.

Reduced configs of Mamba2-370M (2 Mamba blocks, d_model 64, state 16,
head dim 16: 8 heads) and Zamba2-1.2B (4 Mamba blocks in 2 groups of 2,
each followed by the one shared attention+MLP block), in f32, with the
JAX package's params carried across by ``models/convert.py``.  Logits,
caches and the scan's states within ``F32_ATOL`` (1e-5,
``tests/torch_lm_cases.py``); a Mamba block's output and the scan's y,
which reach tens at these widths, within 1e-5 of their largest |value|
(``close_scaled``); greedy tokens exactly.  The SSD scan is held at
S < chunk, S > chunk with padding, an initial state and grouped B/C; in
bf16 within ``BF16_ATOL`` (5e-2) of its scale, the two frameworks
rounding at other places.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models import ssm_lm as JSL
from repro.models.runtime import Runtime as JaxRuntime
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.models import get_model, ssm, ssm_lm
from repro_torch.models.runtime import Runtime
from repro_torch.serve.engine import ServeEngine
from torch_lm_cases import (BF16_ATOL, F32_ATOL, close, close_scaled,
                            close_tree, every_leaf_carried,
                            golden_is_current, pair, port_meets_golden,
                            tokens)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("mamba2-370m", "zamba2-1.2b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(B, S, H, P, G, N, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P), dtype=np.float32).astype(dtype)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32)))
    A = -np.exp(rng.standard_normal(H, dtype=np.float32) * 0.5)
    Bm, Cm = (rng.standard_normal((B, S, G, N), dtype=np.float32
                                  ).astype(dtype) for _ in range(2))
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("S,chunk,G,h0", [
    (20, 32, 1, False),          # S < chunk: one chunk of S
    (100, 32, 1, False),         # 4 chunks, the last padded
    (96, 32, 2, True),           # grouped B/C, an initial state
    (64, 64, 1, True),
])
def test_ssd_chunked_matches_jax(S, chunk, G, h0):
    xh, dt, A, Bm, Cm = _ssd_inputs(2, S, 4, 8, G, 16, seed=S + G)
    h_init = (np.random.default_rng(1).standard_normal((2, 4, 8, 16),
                                                       dtype=np.float32)
              if h0 else None)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                            chunk=chunk,
                            h0=None if h_init is None else jnp.asarray(h_init))
    y, h = ssm.ssd_chunked(*map(_t, (xh, dt, A, Bm, Cm)), chunk=chunk,
                           h0=None if h_init is None else _t(h_init))
    assert y.shape == (2, S, 4, 8) and h.dtype == torch.float32
    close_scaled(y, jy, "y")
    close_scaled(h, jh, "h_last")


def test_ssd_chunked_bf16_matches_jax():
    """In bf16 the scores, chunk weights and carried states are rounded to
    bf16 before the products that read them, as the JAX package rounds
    them; the products accumulate in f32."""
    import ml_dtypes
    xh, dt, A, Bm, Cm = _ssd_inputs(1, 80, 4, 8, 1, 16, seed=3,
                                    dtype=ml_dtypes.bfloat16)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), chunk=32)
    y, h = ssm.ssd_chunked(*(_t(a.astype(np.float32)).to(
        torch.bfloat16 if a.dtype == ml_dtypes.bfloat16 else torch.float32)
        for a in (xh, dt, A, Bm, Cm)), chunk=32)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    w = np.asarray(jy, np.float32)
    np.testing.assert_allclose(y.float().numpy(), w, rtol=BF16_ATOL,
                               atol=BF16_ATOL * np.abs(w).max())


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 9, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32)
    b = rng.standard_normal(12, dtype=np.float32)
    want = JS._causal_conv(*map(jnp.asarray, (u, w, b)))
    close(conv := ssm._causal_conv(*map(_t, (u, w, b))), want, F32_ATOL)
    assert conv.shape == u.shape


@pytest.mark.parametrize("S", [2, 300])
def test_mamba_fwd_state_and_step_match_jax(S):
    """A block's output and decode cache at S < K-1 (the conv cache
    left-padded) and S > chunk, then two recurrent steps from that cache
    and from ``init_mamba_cache``'s."""
    jcfg, params, cfg, model = pair("mamba2-370m")
    jp = jax.tree.map(lambda a: a[0], params["tail"]["mixer"])
    p = model["tail"][0]["mixer"]
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model),
                                                 dtype=np.float32)
    jfwd = jax.jit(lambda p, x: JS.mamba_fwd(p, x, jcfg, chunk=32,
                                             return_state=True))
    jstep = jax.jit(lambda p, x, c: JS.mamba_step(p, x, c, jcfg))
    jy, jst = jfwd(jp, jnp.asarray(x))
    y, st = ssm.mamba_fwd(p, _t(x), cfg, chunk=32, return_state=True)
    close_scaled(y, jy, "y")
    close_tree(st, jst, F32_ATOL, "state")
    fresh = (JS.init_mamba_cache(jcfg, 2),
             ssm.init_mamba_cache(cfg, 2, device="cpu"))
    assert fresh[1]["conv"].dtype == torch.float32
    for jc, pc in ((jst, st), fresh):
        for step in range(2):
            x1 = np.random.default_rng(50 + step).standard_normal(
                (2, 1, cfg.d_model), dtype=np.float32)
            jy, jc = jstep(jp, jnp.asarray(x1), jc)
            y, pc = ssm.mamba_step(p, _t(x1), pc, cfg)
            close_scaled(y, jy, f"step {step}")
            close_tree(pc, jc, F32_ATOL, f"step {step} cache")


@pytest.mark.parametrize("mode", ["dense", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, mode):
    jcfg, params, cfg, model = pair(arch)
    toks = tokens(cfg, (2, 40))
    rt = dict(attn_mode=mode, ssd_chunk=16)
    want, _ = JSL.forward(params, jnp.asarray(toks), jcfg, JaxRuntime(**rt))
    got, aux = ssm_lm.forward(model, torch.from_numpy(toks), cfg,
                              Runtime(**rt))
    close(got, want, F32_ATOL, f"{arch} {mode}")
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_jax(arch):
    jcfg, params, cfg, model = pair(arch)
    api = get_model(cfg)
    toks = tokens(cfg, (2, 37), seed=1)
    rt = dict(attn_mode="chunked", ssd_chunk=16)
    jrt, prt = JaxRuntime(**rt), Runtime(**rt)
    jl, jc = JSL.prefill(params, jnp.asarray(toks), jcfg, jrt, max_len=44)
    pl, pc = api.prefill(model, torch.from_numpy(toks), prt, max_len=44)
    close(pl, jl, F32_ATOL, "prefill logits")
    close_tree(pc, jc, F32_ATOL, "prefill cache")
    for step in range(3):
        nxt = tokens(cfg, (2, 1), seed=10 + step)
        jl, jc = JSL.decode_step(params, jc, jnp.asarray(nxt), jcfg, jrt)
        pl, pc = api.decode_step(model, pc, torch.from_numpy(nxt), prt)
        close(pl, jl, F32_ATOL, f"decode step {step}")
    close_tree(pc, jc, F32_ATOL, "cache after decode")
    empty = api.init_cache(2, 44, prt, device="cpu")
    close_tree(empty, JSL.init_cache(jcfg, 2, 44, jrt), 0.0, "init_cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_equals_jax(arch):
    """Greedy tokens equal the JAX ServeEngine's exactly on short prompts
    (the long ones are the golden file's)."""
    jcfg, params, cfg, model = pair(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (7, 30, 12)]
    rt = dict(attn_mode="chunked", ssd_chunk=8)
    want = JaxEngine(jcfg, rt=JaxRuntime(**rt)).generate(
        params, prompts, max_new_tokens=8)
    got = ServeEngine(cfg, rt=Runtime(**rt), device="cpu").generate(
        model, prompts, max_new_tokens=8)
    assert got.tokens == want.tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_leaf(arch):
    every_leaf_carried(arch)


def test_hybrid_layout():
    """Zamba2's reduced layout: 2 groups of 2 Mamba blocks, the one shared
    block, no tail; at full width 6 groups of 6 and 2 tail blocks."""
    from repro_torch.configs import get_config
    _, _, cfg, model = pair("zamba2-1.2b")
    assert len(model["groups"]) == 2 and "tail" not in model
    assert [len(g) for g in model["groups"]] == [2, 2]
    assert ssm_lm._group_split(get_config("zamba2-1.2b")) == (6, 2)
    assert ssm_lm._group_split(get_config("mamba2-370m")) == (0, 48)


# ---- the golden file that chip_smoke.py phase 16 (b) holds the card to --
@pytest.mark.parametrize("arch", ARCHS)
def test_golden_family_is_current(arch):
    golden_is_current(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_family_met_by_port_on_cpu(arch, monkeypatch):
    port_meets_golden(arch, monkeypatch)
