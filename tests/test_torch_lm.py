"""The port's dense LM serving path on the CPU against the JAX package.

Reduced configs (``reduced()``: 2 layers, d_model 64, head dim 16) of
Llama-3.2-1B, Qwen1.5-0.5B (QKV bias) and h2o-danube-1.8B (sliding
window), the dense family.  The JAX package initialises the params;
``models/convert.py`` carries them across, so both packages compute with
the same weights on the same tokens.

Tolerances: in f32 the two packages sum the same products in other orders
(and the port's chunked attention walks 64-key tiles where JAX's walks
512/1024-token blocks); the logits, of magnitude under 1, part by under
1e-6, so ``F32_ATOL`` is 1e-5.  In bf16 the two frameworks round
intermediate values at other places; the logits part by about 1e-2, so
``BF16_ATOL`` is 5e-2, the bf16 tolerance of ``tests/test_kernels.py``.
Greedy tokens are compared exactly.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.models.runtime import Runtime as JaxRuntime
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import launches, reset_launches
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model, transformer
from repro_torch.models.convert import (flatten, from_jax, to_tensor,
                                        unflatten)
from repro_torch.models.runtime import Runtime
from repro_torch.serve.engine import ServeEngine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_golden import GOLDEN_LM, compute_golden_lm  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

ARCHS = ("llama3.2-1b", "qwen1.5-0.5b", "h2o-danube-1.8b")
F32_ATOL = 1e-5
BF16_ATOL = 5e-2


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str = "float32"):
    """(JAX cfg, JAX params, port cfg, port model) of a reduced config."""
    jcfg = jax_config(arch).reduced().replace(dtype=dtype)
    cfg = get_config(arch).reduced().replace(dtype=dtype)
    params = JT.init(jax.random.key(0), jcfg)
    return jcfg, params, cfg, from_jax(jax.tree.map(np.asarray, params), cfg,
                                        device="cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=atol,
                               atol=atol, err_msg=what)


def test_config_records_match_jax():
    assert ARCH_NAMES == JAX_ARCH_NAMES
    for arch in ARCH_NAMES:
        mine, ref = get_config(arch), jax_config(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert dataclasses.asdict(mine.reduced()) == \
            dataclasses.asdict(ref.reduced())
        assert mine.padded_vocab == ref.padded_vocab
        for active in (False, True):
            assert mine.param_count(active) == ref.param_count(active)
        assert mine.torch_dtype == getattr(torch, str(ref.np_dtype))


@pytest.mark.parametrize("mode", ["dense", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, mode):
    jcfg, params, cfg, model = _pair(arch)
    toks = _tokens(cfg, (2, 40))
    want, _ = JT.forward(params, jnp.asarray(toks), jcfg,
                         JaxRuntime(attn_mode=mode))
    got, aux = transformer.forward(model, torch.from_numpy(toks), cfg,
                                   Runtime(attn_mode=mode))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, F32_ATOL, f"{arch} {mode}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_jax(arch):
    jcfg, params, cfg, model = _pair(arch)
    api, japi = get_model(cfg), JT
    toks = _tokens(cfg, (2, 37), seed=1)
    jrt, rt = JaxRuntime(attn_mode="chunked"), Runtime(attn_mode="chunked")
    jl, jc = japi.prefill(params, jnp.asarray(toks), jcfg, jrt, max_len=44)
    pl, pc = api.prefill(model, torch.from_numpy(toks), rt, max_len=44)
    _close(pl, jl, F32_ATOL, "prefill logits")
    assert pc["len"] == int(jc["len"]) == 37
    for k in ("k", "v"):
        assert pc[k].shape == jc[k].shape
        _close(pc[k], jc[k], F32_ATOL, f"cache {k}")
    for step in range(3):
        nxt = _tokens(cfg, (2, 1), seed=10 + step)
        jl, jc = japi.decode_step(params, jc, jnp.asarray(nxt), jcfg, jrt)
        pl, pc = api.decode_step(model, pc, torch.from_numpy(nxt), rt)
        _close(pl, jl, F32_ATOL, f"decode step {step}")
    assert pc["len"] == int(jc["len"]) == 40
    _close(pc["k"], jc["k"], F32_ATOL, "cache k after decode")


@pytest.mark.parametrize("mode,lens", [("chunked", (7, 30, 12)),
                                       ("auto", (2100, 40))])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_equals_jax(arch, mode, lens):
    """Greedy tokens equal the JAX ServeEngine's exactly: on short prompts
    through the chunked path, and with ``auto`` on a batch padded past 2048
    tokens (chunked in prefill, so the flash twin and, for h2o-danube, its
    sliding window over a long prompt)."""
    jcfg, params, cfg, model = _pair(arch)
    rng = np.random.default_rng(len(lens))
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    want = JaxEngine(jcfg, rt=JaxRuntime(attn_mode=mode)).generate(
        params, prompts, max_new_tokens=8)
    got = ServeEngine(cfg, rt=Runtime(attn_mode=mode), device="cpu"
                      ).generate(model, prompts, max_new_tokens=8)
    assert got.tokens == want.tokens
    assert got.n_prefill == want.n_prefill and got.n_steps == want.n_steps


@pytest.mark.parametrize("mode", ["dense", "chunked"])
def test_bf16_logits_match_jax(mode):
    jcfg, params, cfg, model = _pair("llama3.2-1b", "bfloat16")
    assert next(model.parameters()).dtype == torch.bfloat16
    toks = _tokens(cfg, (2, 40))
    want, _ = JT.forward(params, jnp.asarray(toks), jcfg,
                         JaxRuntime(attn_mode=mode))
    got, _ = transformer.forward(model, torch.from_numpy(toks), cfg,
                                 Runtime(attn_mode=mode))
    _close(got, want, BF16_ATOL, mode)


# ---- tests/test_serve_engine.py's checks, on the port's engine ----------
@pytest.fixture(scope="module")
def engine():
    cfg = get_config("qwen1.5-0.5b").reduced()
    eng = ServeEngine(cfg, rt=Runtime(), temperature=0.0, device="cpu")
    return eng, eng.api.init(torch.Generator().manual_seed(0))


def test_greedy_deterministic(engine):
    eng, model = engine
    prompts = [[5, 6, 7, 8], [9, 10, 11]]
    a = eng.generate(model, prompts, max_new_tokens=8)
    b = eng.generate(model, prompts, max_new_tokens=8)
    assert a.tokens == b.tokens
    assert all(len(t) == 8 for t in a.tokens)


def test_batch_consistency(engine):
    eng, model = engine
    p = [3, 4, 5, 6, 7, 8]
    solo = eng.generate(model, [p], max_new_tokens=6).tokens[0]
    batch = eng.generate(model, [p, p], max_new_tokens=6).tokens
    assert batch[0] == solo and batch[1] == solo


def test_stop_token(engine):
    eng, model = engine
    res = eng.generate(model, [[5, 6, 7]], max_new_tokens=12)
    stop = res.tokens[0][2]
    res2 = eng.generate(model, [[5, 6, 7]], max_new_tokens=12,
                        stop_token=stop)
    assert res2.tokens[0][-1] == stop
    assert len(res2.tokens[0]) <= 3


def test_tokens_in_vocab(engine):
    eng, model = engine
    res = eng.generate(model, [[1, 2, 3]], max_new_tokens=10)
    assert all(0 <= t < eng.cfg.vocab_size for t in res.tokens[0])


def test_temperature_sampling_reproducible(engine):
    """Samples come from a torch.Generator seeded with ``seed``: the same
    seed gives the same tokens.  (jax.random's draws differ, so they are
    not compared with the JAX engine's.)"""
    _, model = engine
    cfg = get_config("qwen1.5-0.5b").reduced()
    prompts = [[5, 6, 7, 8], [9, 10, 11]]

    def sample(seed):
        return ServeEngine(cfg, temperature=1.0, seed=seed, device="cpu"
                           ).generate(model, prompts, max_new_tokens=12).tokens
    a, b, c = sample(3), sample(3), sample(4)
    assert a == b and a != c
    assert all(0 <= t < cfg.vocab_size for row in a + c for t in row)


# ---- the entry points' contract -----------------------------------------
def test_default_device_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA card"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA card"):
        launch_serve.main(["--arch", "llama3.2-1b", "--reduced"])
    # carrying weights across and making a cache default to the card too
    params = unflatten(dict(np.load(GOLDEN_LM)), "params/")
    with pytest.raises(RuntimeError, match="CUDA card"):
        from_jax(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA card"):
        to_tensor(np.zeros(3))
    with pytest.raises(RuntimeError, match="CUDA card"):
        get_model(cfg).init_cache(2, 8, Runtime())
    cache = get_model(cfg).init_cache(2, 8, Runtime(), device="cpu")
    assert cache["k"].device.type == "cpu" and cache["len"] == 0
    reset_launches()
    assert launch_serve.main(["--arch", "llama3.2-1b", "--reduced",
                              "--device", "cpu", "--batch", "2",
                              "--prompt-len", "12", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "req 1:" in out and "on cpu" in out
    assert not any(launches().values())


def test_port_walk_reaches_the_lm_subpackages():
    """tests/test_torch_session.py imports every module pkgutil finds under
    repro_torch and checks that jax and repro stay out: the LM slice's
    subpackages are among them."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for sub in ("configs", "models", "serve", "launch",
                "kernels.flash_attn"):
        assert f"repro_torch.{sub}" in names
    assert {"repro_torch.models.convert", "repro_torch.serve.engine",
            "repro_torch.launch.serve", "repro_torch.models.moe",
            "repro_torch.models.ssm", "repro_torch.models.ssm_lm",
            "repro_torch.models.encdec", "repro_torch.models.vlm"} <= names


def test_nccl_and_runtime_refusals_raise():
    """What still raises: an NCCL mesh with more ranks than visible cards,
    and a runtime naming an axis its mesh lacks or a setting it does not
    know.  Every family runs on a mesh (tests/test_torch_mesh.py,
    tests/test_torch_mesh_families.py) and on one device."""
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as launch_train

    class Mesh:                       # a 2 x 2 stand-in: no ranks needed
        mesh_dim_names = ("data", "model")
        shape = {"data": 2, "model": 2}
        device_type = "cpu"
    with pytest.raises(RuntimeError, match="NCCL refuses"):
        launch_mesh.check_cards(torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match="NCCL refuses"):
        launch_train.main(["--reduced", "--device", "cpu", "--backend",
                           "nccl", "--dp", "2"])
    with pytest.raises(ValueError, match="not a dim of the mesh"):
        Runtime(mesh=Mesh(), tp_axis="tensor")
    with pytest.raises(ValueError, match="act_shard"):
        Runtime(act_shard="batch")
    with pytest.raises(ValueError, match="attn_mode"):
        Runtime(attn_mode="flash")
    with pytest.raises(ValueError, match="moe_impl"):
        Runtime(moe_impl="dense")
    with pytest.raises(ValueError, match="ssd_chunk"):
        Runtime(ssd_chunk=0)
    with pytest.raises(ValueError, match="remat_group"):
        Runtime(remat_group=0)
    with pytest.raises(ValueError, match="loss_chunk"):
        Runtime(loss_chunk=-1)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_get_model_serves_every_config(arch):
    """get_model takes all ten configs; the API has the JAX package's
    shape (enc-dec has no ``forward``, as there)."""
    cfg = get_config(arch)
    api = get_model(cfg)
    assert api.cfg is cfg
    assert (api.forward is None) == (cfg.family == "encdec")


def test_convert_carries_every_param():
    jcfg, params, cfg, model = _pair("qwen1.5-0.5b")
    flat = flatten(jax.tree.map(np.asarray, params))
    assert flatten(unflatten(flat)).keys() == flat.keys()
    sd = model.state_dict()
    per_layer = sum(k.startswith("layers/") for k in flat)
    assert len(sd) == len(flat) - per_layer + cfg.n_layers * per_layer
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            sd[f"layers.{i}.attn.bq"].numpy(),
            np.asarray(params["layers"]["attn"]["bq"][i]))
    np.testing.assert_array_equal(sd["embed.table"].numpy(),
                                  np.asarray(params["embed"]["table"]))
    bf = np.asarray(jnp.asarray([1.5, -3.0, 1e-3], jnp.bfloat16))
    assert to_tensor(bf, "cpu").dtype == torch.bfloat16
    assert to_tensor(bf, "cpu").float().tolist() \
        == bf.astype(np.float32).tolist()
    short = flatten(jax.tree.map(np.asarray, params))
    short = {k: (v[:1] if k.startswith("layers/") else v)
             for k, v in short.items()}
    with pytest.raises(ValueError, match="layers"):
        from_jax(unflatten(short), cfg, device="cpu")


# ---- the golden file that chip_smoke.py holds the card to ---------------
def test_golden_lm_file_is_current():
    """The committed golden_lm.npz still equals what the JAX package
    computes: params and tokens exactly, logits within rtol 1e-6 (the
    last bits of another CPU's vector unit)."""
    want = compute_golden_lm()
    got = np.load(GOLDEN_LM)
    assert sorted(got.files) == sorted(want)
    for k, w in want.items():
        if k.endswith("last_logits"):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_golden_lm_matches_port_on_cpu():
    """The check chip_smoke.py phase 10 makes on the card, on the CPU."""
    golden = np.load(GOLDEN_LM)
    cfg = get_config(str(golden["arch"])).reduced().replace(
        dtype=str(golden["dtype"]))
    model = from_jax(unflatten(golden, "params/"), cfg, device="cpu")
    eng = ServeEngine(cfg, device="cpu")
    for batch in ("long", "short"):
        n = int(golden[f"{batch}/n_prompts"])
        prompts = [golden[f"{batch}/prompt/{i}"].tolist() for i in range(n)]
        res = eng.generate(model, prompts,
                           max_new_tokens=int(golden["new_tokens"]))
        assert res.tokens == golden[f"{batch}/tokens"].tolist(), batch
        Lp = max(map(len, prompts))
        toks = torch.zeros(n, Lp, dtype=torch.long)
        for i, p in enumerate(prompts):
            toks[i, Lp - len(p):] = torch.tensor(p)
        logits, _ = eng.api.prefill(model, toks, eng.rt)
        _close(logits[:, -1], golden[f"{batch}/last_logits"], F32_ATOL,
               batch)
