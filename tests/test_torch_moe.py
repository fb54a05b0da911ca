"""The port's MoE family (``models/moe.py`` and the MoE route of
``models/transformer.py``) on the CPU against the JAX package.

Reduced configs (``reduced()``: 2 layers, d_model 64, 4 experts of
width 32, top-2) of Granite-3.0-1B-A400M and of Kimi-K2 (one shared
expert), in f32, with the JAX package's params carried across by
``models/convert.py``.  Logits and caches within ``F32_ATOL`` (1e-5,
``tests/torch_lm_cases.py``); the MoE layer's output, which reaches tens
here (the JAX package's init scales an expert's weights by 1/sqrt(E) of
its leading axis), within 1e-5 of its largest |value|
(``close_scaled``); expert ids, kept assignments and greedy tokens
exactly.  Long prompts overflow the capacity, so drops are exercised;
so are ties in the top-k (broken to the lower expert index, as
``lax.top_k`` breaks them).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.runtime import Runtime as JaxRuntime
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.models import get_model, moe, transformer
from repro_torch.models.runtime import Runtime
from repro_torch.serve.engine import ServeEngine
from torch_lm_cases import (F32_ATOL, close, close_scaled, close_tree,
                            every_leaf_carried, golden_is_current, pair,
                            port_meets_golden, tokens)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _xf(cfg, n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.d_model), dtype=np.float32)


@pytest.mark.parametrize("tie", [False, True])
def test_route_matches_jax(tie):
    jcfg, params, cfg, model = pair("granite-moe-1b-a400m")
    router = np.asarray(params["layers"]["moe"]["router"][0])
    if tie:      # experts 1, 2 and 3 route alike: equal probabilities
        router = router.copy()
        router[:, 3] = router[:, 1]
        router[:, 2] = router[:, 1]
    xf = _xf(cfg, 300)
    je, jg, ja = JM._route(jnp.asarray(xf), jnp.asarray(router), jcfg)
    pe, pg, pa = moe._route(_t(xf), _t(router), cfg)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    close(pg, jg, F32_ATOL, "gates")
    close(pa, ja, F32_ATOL, "aux")
    if tie:
        assert (np.asarray(je) == 1).any()


def test_capacity_matches_jax():
    jcfg, _, cfg, _ = pair("granite-moe-1b-a400m")
    for n in (1, 7, 8, 100, 2401, 16000):
        assert moe._capacity(n, cfg) == JM._capacity(n, jcfg)


@pytest.mark.parametrize("n,E", [(1, 4), (300, 5), (4000, 33)])
def test_rank_in_expert_equals_the_one_hot_cumsum(n, E):
    """The stable-sort rank is the JAX package's one-hot cumsum position
    (``src/repro/models/moe.py:90-93``), the parked slot E - 1
    included."""
    import jax
    e = np.random.default_rng(n).integers(0, E, n)
    oh = jax.nn.one_hot(jnp.asarray(e), E - 1, dtype=jnp.int32)
    want = jnp.take_along_axis(jnp.cumsum(oh, axis=0),
                               jnp.clip(jnp.asarray(e), 0, E - 2)[:, None],
                               axis=1)[:, 0] - 1
    got = moe._rank_in_expert(torch.from_numpy(e))
    local = e < E - 1
    np.testing.assert_array_equal(got.numpy()[local], np.asarray(want)[local])
    for x in range(E):                  # each expert's ranks are 0, 1, ...
        assert sorted(got.numpy()[e == x]) == list(range((e == x).sum()))


@pytest.mark.parametrize("e0,e_local,cap", [(0, 4, 8), (0, 4, 48),
                                            (1, 2, 16), (2, 2, 200)])
def test_dispatch_compute_combine_with_drops(e0, e_local, cap):
    """Capacity 8 and 48 of 100 tokens x top-2 over 4 experts drop
    assignments; a slice of the experts (e0, e_local) parks the rest."""
    jcfg, params, cfg, _ = pair("granite-moe-1b-a400m")
    lp = {k: np.asarray(v[0]) for k, v in params["layers"]["moe"].items()}
    xf = _xf(cfg, 100, seed=1)
    eidx, gates, _ = JM._route(jnp.asarray(xf), jnp.asarray(lp["router"]),
                               jcfg)
    w = [lp[k][e0:e0 + e_local] for k in ("wg", "wu", "wd")]
    want = JM._dispatch_compute_combine(
        jnp.asarray(xf), eidx, gates, *map(jnp.asarray, w), e0=e0,
        e_local=e_local, cap=cap)
    got = moe._dispatch_compute_combine(
        _t(xf), _t(eidx).long(), _t(gates), *map(_t, w), e0=e0,
        e_local=e_local, cap=cap)
    close_scaled(got, want, f"{e0} {e_local} {cap}")
    if cap == 8:          # the drops leave some tokens with no output
        assert (np.abs(np.asarray(want)).sum(-1) == 0).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_matches_jax(arch):
    jcfg, params, cfg, model = pair(arch)
    x = np.random.default_rng(2).standard_normal(
        (2, 150, cfg.d_model), dtype=np.float32)
    jp = jax_layer(params, 1)
    want, jaux = JM.moe_fwd(jp, jnp.asarray(x), jcfg, JaxRuntime())
    got, aux = moe.moe_fwd(model["layers"][1]["moe"], _t(x), cfg, Runtime())
    close_scaled(got, want, arch)
    close(aux, jaux, F32_ATOL, "aux")
    assert ("shared" in model["layers"][1]["moe"]) == bool(
        cfg.n_shared_experts)


def jax_layer(params, i):
    import jax
    return jax.tree.map(lambda a: a[i], params["layers"]["moe"])


@pytest.mark.parametrize("mode", ["dense", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, mode):
    jcfg, params, cfg, model = pair(arch)
    toks = tokens(cfg, (2, 40))
    want, jaux = JT.forward(params, jnp.asarray(toks), jcfg,
                            JaxRuntime(attn_mode=mode))
    got, aux = transformer.forward(model, torch.from_numpy(toks), cfg,
                                   Runtime(attn_mode=mode))
    close(got, want, F32_ATOL, f"{arch} {mode}")
    close(aux, jaux, F32_ATOL, "aux")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_jax(arch):
    jcfg, params, cfg, model = pair(arch)
    api = get_model(cfg)
    toks = tokens(cfg, (2, 37), seed=1)
    jrt, rt = JaxRuntime(attn_mode="chunked"), Runtime(attn_mode="chunked")
    jl, jc = JT.prefill(params, jnp.asarray(toks), jcfg, jrt, max_len=44)
    pl, pc = api.prefill(model, torch.from_numpy(toks), rt, max_len=44)
    close(pl, jl, F32_ATOL, "prefill logits")
    close_tree(pc, jc, F32_ATOL, "prefill cache")
    for step in range(3):
        nxt = tokens(cfg, (2, 1), seed=10 + step)
        jl, jc = JT.decode_step(params, jc, jnp.asarray(nxt), jcfg, jrt)
        pl, pc = api.decode_step(model, pc, torch.from_numpy(nxt), rt)
        close(pl, jl, F32_ATOL, f"decode step {step}")
    close_tree(pc, jc, F32_ATOL, "cache after decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_equals_jax(arch):
    """Greedy tokens equal the JAX ServeEngine's exactly on short prompts
    (the long ones are the golden file's)."""
    jcfg, params, cfg, model = pair(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (7, 30, 12)]
    rt = dict(attn_mode="chunked")
    want = JaxEngine(jcfg, rt=JaxRuntime(**rt)).generate(
        params, prompts, max_new_tokens=8)
    got = ServeEngine(cfg, rt=Runtime(**rt), device="cpu").generate(
        model, prompts, max_new_tokens=8)
    assert got.tokens == want.tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_leaf(arch):
    every_leaf_carried(arch)


# ---- the golden file that chip_smoke.py phase 16 (b) holds the card to --
@pytest.mark.parametrize("arch", ARCHS)
def test_golden_family_is_current(arch):
    golden_is_current(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_family_met_by_port_on_cpu(arch, monkeypatch):
    port_meets_golden(arch, monkeypatch)
