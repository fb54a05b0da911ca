"""The port's enc-dec and VLM families (``models/encdec.py``,
``models/vlm.py``, ``layers.cross_attention_fwd``), the engine's
``extra_inputs`` and the launcher's stub inputs, on the CPU against the
JAX package.

Reduced configs of Whisper-base (2 encoder and 2 decoder layers, d_model
64; 2560 positions where 2100 frames take the chunked path) and
InternVL2-2B (2 layers, 4 stub patches of width 32), in f32, with the JAX
package's params carried across by ``models/convert.py``.  Logits, caches
and the encoder output within ``F32_ATOL`` (1e-5,
``tests/torch_lm_cases.py``); greedy tokens exactly.  The VLM's tokens are
held to the JAX package's greedy loop over its ``prefill`` (cache sized
for patches and text) and ``decode_step``: its ``ServeEngine`` sizes the
VLM cache without the patches (``ROADMAP.md`` queue 3).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import vlm as JV
from repro.models.registry import get_model as jax_model
from repro.models.runtime import Runtime as JaxRuntime
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.kernels import launches, reset_launches
from repro_torch.launch import serve as launch_serve
from repro_torch.models import encdec, get_model, layers, vlm
from repro_torch.models.runtime import Runtime
from repro_torch.serve.engine import ServeEngine
from torch_golden import jax_greedy
from torch_lm_cases import (F32_ATOL, close, close_tree, counted_flash,
                            every_leaf_carried, golden_is_current, pair,
                            port_meets_golden, tokens)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

WHISPER = ("whisper-base", "float32", (("max_abs_positions", 2560),))
VLM = "internvl2-2b"
ARCHS = ("whisper-base", VLM)


def _t(a):
    return torch.from_numpy(np.array(a))


def _frames(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.frontend_dim), dtype=np.float32)


@pytest.mark.parametrize("Sq,Sk", [(7, 40), (1, 2100), (300, 2100)])
def test_cross_attention_fwd_matches_jax(Sq, Sk, monkeypatch):
    """Dense below 2049 positions on both sides, else chunked (one
    chunked call: a kernel launch on the card), non-causal, Sq != Sk."""
    jcfg, params, cfg, model = pair(*WHISPER)
    p = model["dec_layers"][0]["xattn"]
    jp = {k: v[0] for k, v in params["dec_layers"]["xattn"].items()}
    rng = np.random.default_rng(Sq)
    x = rng.standard_normal((2, Sq, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, Sk, cfg.d_model), dtype=np.float32)
    want = JL.cross_attention_fwd(jp, jnp.asarray(x), jnp.asarray(enc), jcfg)
    with counted_flash(monkeypatch) as count:
        got = layers.cross_attention_fwd(p, _t(x), _t(enc), cfg)
    assert count["n"] == (max(Sq, Sk) > 2048)
    close(got, want, F32_ATOL, f"{Sq} {Sk}")


@pytest.mark.parametrize("S", [40, 2100])
def test_encode_matches_jax(S):
    """The encoder: adapter, positions, non-causal self-attention (chunked
    past 2048 frames under ``auto``), the final norm."""
    jcfg, params, cfg, model = pair(*WHISPER)
    frames = _frames(cfg, 1, S)
    want = JE.encode(params, jnp.asarray(frames), jcfg, JaxRuntime())
    got = encdec.encode(model, _t(frames), cfg, Runtime())
    close(got, want, F32_ATOL, str(S))


def test_encdec_prefill_cache_and_decode_match_jax():
    jcfg, params, cfg, model = pair(*WHISPER)
    api = get_model(cfg)
    toks = tokens(cfg, (2, 21), seed=1)
    frames = _frames(cfg, 2, 2100, seed=2)
    jl, jc = JE.prefill(params, {"tokens": jnp.asarray(toks),
                                 "frames": jnp.asarray(frames)}, jcfg,
                        JaxRuntime(), max_len=30)
    pl, pc = api.prefill(model, {"tokens": torch.from_numpy(toks),
                                 "frames": _t(frames)}, Runtime(),
                         max_len=30)
    close(pl, jl, F32_ATOL, "prefill logits")
    close_tree(pc, jc, F32_ATOL, "prefill cache")
    for step in range(3):
        nxt = tokens(cfg, (2, 1), seed=10 + step)
        jl, jc = JE.decode_step(params, jc, jnp.asarray(nxt), jcfg,
                                JaxRuntime())
        pl, pc = api.decode_step(model, pc, torch.from_numpy(nxt), Runtime())
        close(pl, jl, F32_ATOL, f"decode step {step}")
    close_tree(pc, jc, F32_ATOL, "cache after decode")
    empty = api.init_cache(2, 30, Runtime(), enc_len=50, device="cpu")
    close_tree(empty, JE.init_cache(jcfg, 2, 30, JaxRuntime(), enc_len=50),
               0.0, "init_cache")


def test_project_matches_jax():
    jcfg, params, cfg, model = pair(VLM)
    patches = _frames(cfg, 2, cfg.n_patches, seed=3)
    close(vlm._project(model, _t(patches), cfg),
          JV._project(params, jnp.asarray(patches), jcfg), F32_ATOL)


@pytest.mark.parametrize("mode", ["dense", "chunked"])
def test_vlm_forward_logits_match_jax(mode):
    jcfg, params, cfg, model = pair(VLM)
    toks = tokens(cfg, (2, 40))
    patches = _frames(cfg, 2, cfg.n_patches, seed=3)
    want, _ = JV.forward(params, {"tokens": jnp.asarray(toks),
                                  "patches": jnp.asarray(patches)}, jcfg,
                         JaxRuntime(attn_mode=mode))
    got, _ = get_model(cfg).forward(model, {"tokens": torch.from_numpy(toks),
                                            "patches": _t(patches)},
                                    Runtime(attn_mode=mode))
    assert got.shape[1] == cfg.n_patches + 40
    close(got, want, F32_ATOL, mode)


def test_vlm_prefill_cache_and_decode_match_jax():
    """The cache holds the patches' positions and the text's: ``max_len``
    counts text, as ServeEngine passes it, so the JAX package is asked
    for P more."""
    jcfg, params, cfg, model = pair(VLM)
    api = get_model(cfg)
    toks = tokens(cfg, (2, 17), seed=1)
    patches = _frames(cfg, 2, cfg.n_patches, seed=4)
    jrt, rt = JaxRuntime(attn_mode="chunked"), Runtime(attn_mode="chunked")
    jl, jc = JV.prefill(params, {"tokens": jnp.asarray(toks),
                                 "patches": jnp.asarray(patches)}, jcfg, jrt,
                        max_len=cfg.n_patches + 24)
    pl, pc = api.prefill(model, {"tokens": torch.from_numpy(toks),
                                 "patches": _t(patches)}, rt, max_len=24)
    close(pl, jl, F32_ATOL, "prefill logits")
    close_tree(pc, jc, F32_ATOL, "prefill cache")
    assert pc["len"] == cfg.n_patches + 17
    for step in range(3):
        nxt = tokens(cfg, (2, 1), seed=10 + step)
        jl, jc = JV.decode_step(params, jc, jnp.asarray(nxt), jcfg, jrt)
        pl, pc = api.decode_step(model, pc, torch.from_numpy(nxt), rt)
        close(pl, jl, F32_ATOL, f"decode step {step}")
    close_tree(pc, jc, F32_ATOL, "cache after decode")


def test_generate_greedy_equals_jax():
    """Greedy tokens on short prompts equal the JAX package's: Whisper's
    ServeEngine.generate with its frames in ``extra_inputs`` (numpy), and
    the VLM's greedy loop with its patches (a tensor) (the long prompts
    are the golden file's)."""
    rng = np.random.default_rng(5)
    jcfg, params, cfg, model = pair(*WHISPER)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (7, 19)]
    frames = _frames(cfg, 2, 48, seed=6)
    want = JaxEngine(jcfg).generate(params, prompts, max_new_tokens=8,
                                    extra_inputs={"frames": jnp.asarray(
                                        frames)})
    got = ServeEngine(cfg, device="cpu").generate(
        model, prompts, max_new_tokens=8, extra_inputs={"frames": frames})
    assert got.tokens == want.tokens

    jcfg, params, cfg, model = pair(VLM)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (7, 19)]
    patches = _frames(cfg, 2, cfg.n_patches, seed=7)
    toks = np.zeros((2, 19), np.int32)
    for i, p in enumerate(prompts):
        toks[i, 19 - len(p):] = p
    want, _ = jax_greedy(jax_model(jcfg), params, {"tokens": jnp.asarray(toks),
                                      "patches": jnp.asarray(patches)},
                         JaxRuntime(), cfg.n_patches + 19 + 9, 8,
                         cfg.vocab_size)
    got = ServeEngine(cfg, device="cpu").generate(
        model, prompts, max_new_tokens=8,
        extra_inputs={"patches": _t(patches)})
    assert got.tokens == want


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_leaf(arch):
    every_leaf_carried(arch)


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-2b",
                                  "granite-moe-1b-a400m", "zamba2-1.2b"])
def test_launch_serve_runs_the_family_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <family> --reduced
    --device cpu`` serves each family past dense, stub inputs included,
    and launches no kernel on the CPU."""
    reset_launches()
    assert launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "12",
                              "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "req 1:" in out and "on cpu" in out
    assert not any(launches().values())


# ---- the golden file that chip_smoke.py phase 16 (b) holds the card to --
@pytest.mark.parametrize("arch", ARCHS)
def test_golden_family_is_current(arch):
    golden_is_current(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_family_met_by_port_on_cpu(arch, monkeypatch):
    port_meets_golden(arch, monkeypatch)
