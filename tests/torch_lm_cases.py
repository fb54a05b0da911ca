"""Shared cases of the LM family tests (``tests/test_torch_moe.py``,
``test_torch_ssm.py``, ``test_torch_encdec_vlm.py``): the JAX package's
reduced model and the port's with the same weights, the golden file of
the families (``src/repro_torch/data/golden_lm_families.npz``) recomputed
once a process, the check ``chip_smoke.py`` phase 16 (b) makes on the
card, made on the CPU, and a count of the model code's chunked-attention
calls (on the card each is one ``flash_fwd`` launch; on the CPU the plain
recurrence counts nothing).

Tolerances: f32 logits and caches within ``F32_ATOL`` (1e-5), as
``tests/test_torch_lm.py``: the two packages sum the same products in
other orders and part by under 1e-6 at these magnitudes.  A module's
output is held within 1e-5 of its own scale (:func:`close_scaled`:
``F32_ATOL`` times the largest |value|, at least 1): a MoE expert's or a
Mamba block's output reaches tens at these widths, where an f32 sum in
another order moves the last bits of an element near 0 by ~1e-5.  Greedy
tokens are compared exactly.
"""
from __future__ import annotations

import contextlib
import functools
import importlib.util
import itertools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.convert import flatten, from_jax, unflatten
from repro_torch.serve.engine import ServeEngine
from torch_golden import (GOLDEN_LM_FAMILIES, compute_golden_lm_family,
                          family_cfg)

F32_ATOL = 1e-5
BF16_ATOL = 5e-2

_CHIP_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"



@functools.lru_cache(maxsize=None)
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _CHIP_SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def pair(arch: str, dtype: str = "float32", overrides: tuple = ()):
    """(JAX cfg, JAX params, port cfg, port model on the CPU) of a reduced
    config, the params from the JAX package's ``init(key(0))``."""
    jcfg = jax_config(arch).reduced().replace(dtype=dtype, **dict(overrides))
    cfg = get_config(arch).reduced().replace(dtype=dtype, **dict(overrides))
    params = jax_model(jcfg).init(jax.random.key(0))
    return jcfg, params, cfg, from_jax(jax.tree.map(np.asarray, params), cfg,
                                        device="cpu")


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=atol,
                               atol=atol, err_msg=what)


def close_scaled(got, want, what=""):
    """got within ``F32_ATOL`` times the scale of want (its largest |value|,
    at least 1), element by element."""
    w = np.asarray(want, np.float32)
    atol = F32_ATOL * max(1.0, float(np.abs(w).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float32), w, rtol=F32_ATOL,
                               atol=atol, err_msg=what)


def close_tree(got, want, atol, where=""):
    """A port cache (dict of tensors and ints) within ``atol`` of the JAX
    package's, leaf by leaf, same shapes."""
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        if isinstance(w, dict):
            close_tree(got[k], w, atol, f"{where}/{k}")
        elif k == "len":
            assert got[k] == int(w), where
        else:
            assert tuple(got[k].shape) == tuple(w.shape), f"{where}/{k}"
            close(got[k], w, atol, f"{where}/{k}")


@contextlib.contextmanager
def counted_flash(monkeypatch):
    """Count the model code's chunked-attention calls: the launches
    ``flash_fwd`` would make on the card."""
    counts = {"n": 0}
    inner = L.chunked_attention

    def counting(*a, **kw):
        counts["n"] += 1
        return inner(*a, **kw)
    with monkeypatch.context() as m:
        m.setattr(L, "chunked_attention", counting)
        yield counts


def every_leaf_carried(arch: str) -> None:
    """``from_jax`` carries every leaf of the JAX tree, block by block,
    exactly; a short or missing leaf raises."""
    import pytest
    jcfg, params, cfg, model = pair(arch)
    flat = flatten(jax.tree.map(np.asarray, params))
    sd = model.state_dict()
    lead = {"layers": 1, "enc_layers": 1, "dec_layers": 1, "tail": 1,
            "groups": 2}
    n = 0
    for key, v in flat.items():
        root, rest = key.split("/", 1) if "/" in key else (key, "")
        k = lead.get(root, 0)
        for idx in itertools.product(*map(range, v.shape[:k])):
            name = ".".join([root, *map(str, idx)] + ([rest.replace(
                "/", ".")] if rest else []))
            np.testing.assert_array_equal(sd[name].numpy(), v[idx],
                                          err_msg=name)
            n += 1
    assert n == len(sd)
    short = {k: (v[:1] if "/" in k and lead.get(k.split("/")[0]) else v)
             for k, v in flat.items()}
    with pytest.raises(ValueError, match="shape"):
        from_jax(unflatten(short), cfg, device="cpu")
    first = sorted(flat)[0]
    with pytest.raises(ValueError, match=first):
        from_jax(unflatten({k: v for k, v in flat.items() if k != first}),
                 cfg, device="cpu")


# ---- the golden file of the families ------------------------------------
golden_family = functools.lru_cache(maxsize=None)(compute_golden_lm_family)


def golden_is_current(arch: str) -> None:
    """The committed entries of ``arch`` still equal what the JAX package
    computes: params, inputs and tokens exactly, logits within rtol 1e-6
    (the last bits of another CPU's vector unit)."""
    want = golden_family(arch)
    got = np.load(GOLDEN_LM_FAMILIES)
    assert sorted(k for k in got.files if k.startswith(arch + "/")) \
        == sorted(want)
    for k, w in want.items():
        if k.endswith("last_logits"):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def golden_inputs(golden, pre: str) -> tuple[list, dict]:
    """A golden batch's prompts and its stub inputs (f32 numpy)."""
    n = int(golden[pre + "n_prompts"])
    prompts = [golden[f"{pre}prompt/{i}"].tolist() for i in range(n)]
    extra = {k: golden[pre + k].astype(np.float32)
             for k in ("frames", "patches") if pre + k in golden}
    return prompts, extra


def padded(prompts) -> torch.Tensor:
    Lp = max(map(len, prompts))
    toks = torch.zeros(len(prompts), Lp, dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, Lp - len(p):] = torch.tensor(p)
    return toks


def port_meets_golden(arch: str, monkeypatch) -> None:
    """The check ``chip_smoke.py`` phase 16 (b) makes on the card, on the
    CPU: greedy tokens equal the JAX package's, prefill's last logits
    within ``F32_ATOL``, and the chunked-attention calls of ``generate``,
    of one prefill and of one decode step equal
    ``chip_smoke.flash_launches``."""
    golden = np.load(GOLDEN_LM_FAMILIES)
    pre = arch + "/"
    cfg = family_cfg(get_config, arch,
                     json.loads(str(golden[pre + "overrides"])))
    model = from_jax(unflatten(golden, pre + "params/"), cfg, device="cpu")
    eng = ServeEngine(cfg, device="cpu")
    new = int(golden[pre + "new_tokens"])
    for batch in ("long", "short"):
        prompts, extra = golden_inputs(golden, f"{pre}{batch}/")
        toks = padded(prompts)
        enc_len = extra["frames"].shape[1] if "frames" in extra else 0
        n_pre, n_dec = chip_smoke().flash_launches(cfg, toks.shape[1],
                                                   enc_len)
        with counted_flash(monkeypatch) as count:
            res = eng.generate(model, prompts, max_new_tokens=new,
                               extra_inputs=extra)
        assert res.tokens == golden[f"{pre}{batch}/tokens"].tolist(), batch
        assert count["n"] == n_pre + new * n_dec, batch
        inputs = {"tokens": toks, **{k: torch.from_numpy(v)
                                     for k, v in extra.items()}}
        with counted_flash(monkeypatch) as count:
            logits, cache = eng.api.prefill(model, inputs, eng.rt,
                                            max_len=toks.shape[1] + 2)
        assert count["n"] == n_pre, batch
        close(logits[:, -1], golden[f"{pre}{batch}/last_logits"], F32_ATOL,
              batch)
        with counted_flash(monkeypatch) as count:
            eng.api.decode_step(model, cache, toks[:, -1:], eng.rt)
        assert count["n"] == n_dec, batch
