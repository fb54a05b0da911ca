"""The port's training slice against the JAX package's: the flash-attention
gradient (``models/layers.py::FlashAttention``), AdamW, the train step,
checkpoints, the data pipeline and the train launcher.

The JAX side runs on the CPU as its own tests run it; each JAX function is
jitted once a test.  Tolerances:

* the Function's gradients against ``jax.grad`` of the JAX package's
  ``chunked_attention`` in f32: rtol 1e-5, atol 1e-5 times the largest
  |gradient| (``FN_RTOL``): both add the same f32 block products, in
  other orders where the JAX package takes its triangular schedule;
  against autograd through the port's dense attention, rtol/atol 2e-4 as
  the JAX package's ``test_flash_grads_match_dense``;
* one AdamW update: params, moments and the norm within rtol 1e-5 (and
  1e-7 absolute, ``OPT_RTOL``/``OPT_ATOL``): the same f32 arithmetic, the
  norm's sum in another order; bf16 moments may differ by one bf16
  rounding of a value that lies on the other side of a boundary;
* one train step on reduced Llama in f32: the loss within 1e-5, the
  grad norm within rtol 1e-5, every updated param within 1e-6 absolute
  (``STEP_ATOL``), the step taken from the JAX package's state after its
  first step: AdamW moves a param by ~lr·m/sqrt(v) (lr 3e-3), smooth in
  the gradient once v holds a step's history, where a first step's
  ~lr·g/|g| turns the last bits of a gradient near 0 into a whole step;
* ``synth_batch`` and ``quantize_int8`` exactly.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.data.pipeline import synth_batch as jax_synth_batch
from repro.models import layers as JL
from repro.models.registry import get_model as jax_model
from repro.models.runtime import Runtime as JaxRuntime
from repro.train import optimizer as jopt
from repro.train.train_step import TrainState as JaxTrainState
from repro.train.train_step import make_train_step as jax_make_train_step
from repro.train.train_step import quantize_int8 as jax_quantize_int8
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import Pipeline, synth_batch
from repro_torch.launch import plans
from repro_torch.models import layers as L
from repro_torch.models.convert import (flatten, from_jax, opt_state_from_jax,
                                        to_jax)
from repro_torch.models.registry import get_model
from repro_torch.models.runtime import Runtime
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import make_optimizer, warmup_cosine
from repro_torch.train.train_step import (dequantize_int8, init_state,
                                          make_train_step, quantize_int8)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FN_RTOL = 1e-5
OPT_RTOL, OPT_ATOL = 1e-5, 1e-7
STEP_ATOL = 1e-6
SHAPE = ShapeSpec("t", "train", 32, 8)
JSHAPE = JaxShapeSpec("t", "train", 32, 8)


# --------------------------------------------------------------------------
# the flash-attention gradient
# --------------------------------------------------------------------------
#: (label, B, Sq, Sk, H, Hkv, D, causal, window, q_offset, q_blk, kv_blk):
#: the JAX package's triangular route (causal, square blocks, an even
#: count), its general route (S 130, blocks 64/32, as its
#: test_flash_grads_match_dense), a window, a query offset, non-causal
#: Sq != Sk, each with GQA 4/2
FN_CASES = [
    ("triangular", 2, 128, 128, 4, 2, 16, True, None, 0, 32, 32),
    ("general", 1, 130, 130, 4, 2, 16, True, None, 0, 64, 32),
    ("window", 1, 130, 130, 4, 2, 16, True, 48, 0, 64, 32),
    ("q_offset", 2, 40, 100, 4, 2, 16, True, None, 60, 16, 32),
    ("cross", 2, 48, 130, 4, 2, 32, False, None, 0, 32, 64),
    ("window_offset", 1, 50, 120, 4, 4, 16, True, 30, 70, 16, 16),
]


def _fn_inputs(B, Sq, Sk, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                      (B, Sq, H, D))]


@pytest.mark.parametrize("case", FN_CASES, ids=[c[0] for c in FN_CASES])
def test_flash_grads_equal_jax(case):
    _, B, Sq, Sk, H, Hkv, D, causal, window, q_offset, qb, kb = case
    q, k, v, dout = _fn_inputs(B, Sq, Sk, H, Hkv, D)

    def f(q, k, v):
        return JL.chunked_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, q_blk=qb, kv_blk=kb)
    out_j, vjp = jax.vjp(jax.jit(f), q, k, v)
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = L.chunked_attention(tq, tk, tv, causal=causal, window=window,
                              q_offset=q_offset, q_blk=qb, kv_blk=kb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=FN_RTOL, atol=FN_RTOL)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=FN_RTOL,
                                   atol=FN_RTOL * np.abs(w).max(),
                                   err_msg=f"{case[0]} {name}")


def test_flash_grads_match_dense():
    """``tests/test_models.py::test_flash_grads_match_dense`` on the port:
    the Function's gradient of sum(out²) with q = k = v against autograd
    through the dense attention."""
    q = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 130, 2, 16), dtype=np.float32))

    def grad(fn):
        x = q.clone().requires_grad_(True)
        o = fn(x, x, x, causal=True, window=None)
        return torch.autograd.grad((o.float() ** 2).sum(), x)[0]
    ga = grad(lambda *a, **kw: L.chunked_attention(*a, q_blk=64, kv_blk=32,
                                                   **kw))
    gb = grad(L.dense_attention)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", FN_CASES[1:4], ids=[c[0] for c in
                                                     FN_CASES[1:4]])
def test_flash_grads_match_dense_gqa(case):
    """The Function's three gradients against autograd through the port's
    dense attention (KV heads repeated), masks and offsets included."""
    _, B, Sq, Sk, H, Hkv, D, causal, window, q_offset, qb, kb = case
    arrays = _fn_inputs(B, Sq, Sk, H, Hkv, D, seed=1)
    dout = torch.from_numpy(arrays[3])

    def grads(fn, **kw):
        x = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
        o = fn(*x, causal=causal, window=window, q_offset=q_offset, **kw)
        return torch.autograd.grad(o, x, dout)
    for a, b in zip(grads(L.chunked_attention, q_blk=qb, kv_blk=kb),
                    grads(L.dense_attention)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_flash_backward_skips_empty_key_blocks(monkeypatch):
    """Causal attention's backward visits the lower triangle of block
    pairs only, (n/2)(n+1) of n² (the JAX package's triangular count), and
    masks only the diagonal's blocks."""
    visited, masked = [], []
    visible, mask = L._all_visible, L.attention_mask

    def spy_visible(q0, q1, k0, *a):
        visited.append((q0, k0))
        return visible(q0, q1, k0, *a)

    def spy_mask(q_abs, k_abs, *a):
        masked.append((int(q_abs[0]), int(k_abs[0])))
        return mask(q_abs, k_abs, *a)
    q, k, v, dout = _fn_inputs(1, 128, 128, 2, 2, 16)
    x = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = L.chunked_attention(*x, causal=True, window=None, q_blk=32)
    monkeypatch.setattr(L, "_all_visible", spy_visible)
    monkeypatch.setattr(L, "attention_mask", spy_mask)
    torch.autograd.grad(o, x, torch.from_numpy(dout))
    assert sorted(visited) == [(i, j) for i in range(0, 128, 32)
                               for j in range(0, i + 1, 32)]
    assert sorted(masked) == [(i, i) for i in range(0, 128, 32)]


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------
def _opt_tree(seed=0):
    """A JAX-layout param tree whose leaves cover the optimizer's cases:
    factored matrices (stacked and not), an expert stack, stacked 1-D
    leaves (decayed, not factored) and a 1-D leaf (neither)."""
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s, dtype=np.float32)
    return {"embed": {"table": r(256, 160)},
            "layers": {"attn": {"wq": r(2, 160, 144), "bq": r(2, 144)},
                       "ln1": {"scale": r(2, 160)},
                       "moe": {"wg": r(2, 4, 160, 128)}},
            "final_norm": {"scale": r(160)}}


def _names(tree) -> dict:
    """The port's names of a JAX-layout tree's leaves, each a slice."""
    out = {}
    for path, a in flatten(tree).items():
        root, rest = path.split("/", 1) if "/" in path else (path, "")
        if root == "layers":
            for i in range(a.shape[0]):
                out[f"layers.{i}.{rest.replace('/', '.')}"] = a[i]
        else:
            out[path.replace("/", ".")] = a
    return out


def _random_state(jstate, seed):
    rng = np.random.default_rng(seed)

    def fill(x):
        a = np.asarray(x)
        if a.ndim == 0:
            return jnp.asarray(7, a.dtype)
        vals = np.abs(rng.standard_normal(a.shape)) * 1e-3
        return jnp.asarray(vals.astype(np.float32)).astype(a.dtype)
    return jax.tree.map(fill, jstate)


OPT_CASES = {
    "plain": dict(),
    "factored_bf16_no_momentum": dict(factored=True, momentum=False,
                                      state_dtype="bfloat16"),
    "past_warmup": dict(count=150),
}


@pytest.mark.parametrize("name", OPT_CASES)
def test_adamw_update_equals_jax(name):
    kw = dict(OPT_CASES[name])
    count = kw.pop("count", 7)
    jo = jopt.make_optimizer("adamw", peak_lr=3e-3, warmup=20,
                             total_steps=200, **kw)
    to = make_optimizer("adamw", peak_lr=3e-3, warmup=20, total_steps=200,
                        **kw)
    params = _opt_tree(0)
    grads = jax.tree.map(lambda a: a * 0.3, _opt_tree(1))
    jstate = _random_state(jo.init(params), 2)
    jstate["count"] = jnp.asarray(count, jnp.int32)
    new_p, new_s, gnorm = jax.jit(jo.update)(grads, jstate, params)
    # copies, which the in-place update overwrites with its results
    got_p = {k: torch.from_numpy(np.array(v))
             for k, v in _names(params).items()}
    tgrads = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in _names(grads).items()}
    got_s = opt_state_from_jax(jstate, got_p, device="cpu")
    assert {k: sorted(v) for k, v in got_s["mu"].items()} == {
        k: sorted(v) for k, v in to.init(got_p)["mu"].items()}
    got_n = to.update_(tgrads, got_s, got_p)
    np.testing.assert_allclose(got_n.item(), float(gnorm), rtol=OPT_RTOL)
    assert int(got_s["count"]) == count + 1
    want_p = flatten(jax.tree.map(np.asarray, new_p))
    for k, v in flatten(to_jax(got_p)).items():
        np.testing.assert_allclose(v, want_p[k], rtol=OPT_RTOL,
                                   atol=OPT_ATOL, err_msg=k)
    want_mu = flatten(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   new_s["mu"]))
    got_mu = flatten(to_jax({f"{n}.{m}": t for n, st in got_s["mu"].items()
                             for m, t in st.items()}))
    assert got_mu.keys() == want_mu.keys()
    bf16 = kw.get("state_dtype") == "bfloat16"
    for k, w in want_mu.items():
        np.testing.assert_allclose(got_mu[k], w, rtol=2 ** -7 if bf16 and (
            k.endswith("/m") or k.endswith("/v")) else OPT_RTOL,
            atol=OPT_ATOL, err_msg=k)


def test_warmup_cosine_equals_jax():
    jl = jopt.warmup_cosine(3e-3, 20, 100)
    tl = warmup_cosine(3e-3, 20, 100)
    for s in (0, 1, 5, 19, 20, 21, 50, 99, 100, 150):
        np.testing.assert_allclose(
            tl(torch.tensor(s, dtype=torch.int32)).item(), float(jl(s)),
            rtol=1e-6, err_msg=str(s))


def test_quantize_int8_equals_jax():
    x = np.random.default_rng(0).standard_normal((64, 33)).astype(
        np.float32) * 3
    jq, js = jax_quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and s.item() == float(js)
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(), x,
                               atol=s.item() / 2 + 1e-7)


def test_factored_no_momentum_state_is_smaller():
    cfg = get_config("llama3.2-1b").reduced()
    model = get_model(cfg).init(torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())

    def nbytes(opt):
        st = opt.init(params)
        return sum(t.numel() * t.element_size() for d in st["mu"].values()
                   for t in d.values())
    full = nbytes(make_optimizer("adamw"))
    fac = nbytes(make_optimizer("adamw", factored=True, momentum=False,
                                state_dtype="bfloat16"))
    assert fac < full * 0.30   # momentum dropped + v factored + bf16


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_equals_jax(accum):
    """One step on reduced Llama in f32 from the JAX package's weights and
    optimizer state after its first step (whose update, ~lr·g/|g|, turns
    a gradient's last bits near 0 into a whole step): loss, grad norm and
    every updated param."""
    jcfg = jax_config("llama3.2-1b").reduced().replace(dtype="float32")
    cfg = get_config("llama3.2-1b").reduced().replace(dtype="float32")
    rt_kw = dict(remat=True, loss_chunk=12)
    jo = jopt.make_optimizer("adamw", peak_lr=3e-3, warmup=0,
                             total_steps=100)
    to = make_optimizer("adamw", peak_lr=3e-3, warmup=0, total_steps=100)
    japi = jax_model(jcfg)
    params = japi.init(jax.random.key(0))
    jstate = JaxTrainState(params=params, opt=jo.init(params),
                           step=jnp.zeros((), jnp.int32))
    shape = JaxShapeSpec("t", "train", 32, 4)
    jstep = jax.jit(jax_make_train_step(japi, JaxRuntime(**rt_kw), jo,
                                        accum=accum))
    jstate, _ = jstep(jstate, jax.tree.map(
        jnp.asarray, jax_synth_batch(jcfg, shape, 0)))
    batch = jax_synth_batch(jcfg, shape, 1)
    jnew, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    model = from_jax(jax.tree.map(np.asarray, jstate.params), cfg,
                     device="cpu")
    state = init_state(get_model(cfg), to, model=model, device="cpu")
    state.opt = opt_state_from_jax(jstate.opt, dict(model.named_parameters()),
                                   device="cpu")
    step = make_train_step(get_model(cfg), Runtime(**rt_kw), to,
                           accum=accum, device="cpu")
    state, m = step(state, batch)
    assert state.step == 1 and int(state.opt["count"]) == 2
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(m["nll"].item(), float(jm["nll"]), atol=1e-5)
    want = flatten(jax.tree.map(np.asarray, jnew.params))
    got = flatten(to_jax(dict(state.model.named_parameters())))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=STEP_ATOL,
                                   err_msg=k)


def _setup(arch="llama3.2-1b", **opt_kw):
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    opt = make_optimizer("adamw", peak_lr=3e-3, warmup=5, total_steps=200,
                         **opt_kw)
    state = init_state(api, opt, torch.Generator().manual_seed(0),
                       device="cpu")
    return cfg, api, opt, state


def _run(step_fn, state, cfg, n, start=0):
    losses = []
    for i in range(start, start + n):
        state, metrics = step_fn(state, synth_batch(cfg, SHAPE, i))
        losses.append(metrics["loss"].item())
    return state, losses


def test_loss_decreases():
    cfg, api, opt, state = _setup()
    step = make_train_step(api, Runtime(), opt, device="cpu")
    state, losses = _run(step, state, cfg, 30)
    assert losses[-1] < losses[0] * 0.9
    assert state.step == 30


def test_accum_matches_bigbatch():
    """2 microbatches of B/2 == one batch of B (same grads modulo fp)."""
    cfg, api, opt, state = _setup()
    _, _, _, state2 = _setup()
    s1 = make_train_step(api, Runtime(), opt, device="cpu")
    s2 = make_train_step(api, Runtime(), opt, accum=2, device="cpu")
    batch = synth_batch(cfg, SHAPE, 0)
    st1, m1 = s1(state, batch)
    st2, m2 = s2(state2, batch)
    np.testing.assert_allclose(m1["loss"].item(), m2["loss"].item(),
                               rtol=2e-2)
    l1 = list(st1.model.parameters())[3]
    l2 = list(st2.model.parameters())[3]
    np.testing.assert_allclose(l1.detach().float().numpy(),
                               l2.detach().float().numpy(), atol=2e-2)


def test_checkpoint_crash_recovery(tmp_path):
    cfg, api, opt, state = _setup()
    step = make_train_step(api, Runtime(), opt, device="cpu")
    state, _ = _run(step, state, cfg, 10)
    ckpt.save(str(tmp_path), 10, state)
    saved = {k: v.detach().clone()
             for k, v in ckpt._leaves(state).items()
             if isinstance(v, torch.Tensor)}
    state, _ = _run(step, state, cfg, 3, start=10)   # "lost" work
    # partial (uncommitted) write must be ignored
    os.makedirs(tmp_path / "step_00000013", exist_ok=True)
    (tmp_path / "step_00000013" / "arrays.npz").write_bytes(b"garbage")
    assert ckpt.latest_step(str(tmp_path)) == 10
    restored = ckpt.restore(str(tmp_path), state)
    assert restored.step == 10
    # bit-exact restore (bf16 stored as raw bits)
    leaves = ckpt._leaves(restored)
    assert any(t.dtype == torch.bfloat16 for t in saved.values())
    for k, t in saved.items():
        assert leaves[k].dtype == t.dtype, k
        assert torch.equal(leaves[k].view(torch.uint8) if t.dtype ==
                           torch.bfloat16 else leaves[k],
                           t.view(torch.uint8) if t.dtype == torch.bfloat16
                           else t), k
    man = ckpt.manifest(str(tmp_path))
    assert man["step"] == 10 and set(man["keys"]) == set(saved) | {"step"}
    state10, _ = _run(step, restored, cfg, 1, start=10)
    assert state10.step == 11


def test_checkpoint_prunes_and_refuses_a_misshapen_target(tmp_path):
    cfg, api, opt, state = _setup()
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, state, keep=2)
    assert ckpt.committed_steps(str(tmp_path)) == [3, 4]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    other = init_state(api, opt, device="cpu")
    with torch.no_grad():
        other.model["embed"]["table"].zero_()
    ckpt.restore(str(tmp_path), other, step=3)
    assert torch.equal(other.model["embed"]["table"],
                       state.model["embed"]["table"])
    wide = init_state(get_model(cfg.replace(d_model=32)), opt, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), wide)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), state)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_smoke(arch):
    """Every config's reduced model takes one step of the launcher's plan
    (remat a layer, the loss in chunks of 512): a finite loss and a
    positive, finite grad norm."""
    cfg = get_config(arch).reduced()
    shape = ShapeSpec("smoke", "train", 32, 2)
    plan = plans.default_plan(cfg, shape)
    assert plan.remat and plan.loss_chunk == 512
    api = get_model(cfg)
    opt = make_optimizer(state_dtype=plan.opt_state_dtype,
                         factored=plan.opt_factored,
                         momentum=plan.opt_momentum)
    state = init_state(api, opt, device="cpu")
    step = make_train_step(api, plan.runtime(), opt, device="cpu")
    state, m = step(state, synth_batch(cfg, shape, 0))
    assert np.isfinite(m["loss"].item())
    gn = m["grad_norm"].item()
    assert np.isfinite(gn) and gn > 0


def test_default_plan_one_device_branches():
    train, serve = ShapeSpec("t", "train", 4096, 256), \
        ShapeSpec("p", "prefill", 32768, 32)
    p = plans.default_plan(get_config("llama3.2-1b"), train)
    assert (p.remat, p.remat_group, p.loss_chunk) == (True, 1, 512)
    assert plans.default_plan(get_config("qwen2.5-32b"), train).remat_group \
        == 4
    k = plans.default_plan(get_config("kimi-k2-1t-a32b"), train)
    assert (k.opt_factored, k.opt_state_dtype, k.opt_momentum,
            k.remat_group) == (True, "bfloat16", False, 1)
    s = plans.default_plan(get_config("llama3.2-1b"), serve)
    assert (s.remat, s.loss_chunk) == (False, 0)
    rt = p.runtime()
    assert (rt.remat, rt.remat_group, rt.loss_chunk, rt.attn_mode) == (
        True, 1, 512, "auto")


# --------------------------------------------------------------------------
# the data pipeline, devices, the launcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_synth_batch_equals_jax(arch):
    cfg = get_config(arch).reduced()
    jcfg = jax_config(arch).reduced()
    for step, seed, over in ((0, 0, None), (7, 3, 3)):
        want = jax_synth_batch(jcfg, JSHAPE, step, seed=seed,
                               batch_override=over)
        got = synth_batch(cfg, SHAPE, step, seed=seed, batch_override=over)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_pipeline_regenerates_the_stream():
    cfg = get_config("whisper-base").reduced()
    pipe = Pipeline(cfg, SHAPE, device="cpu", seed=2, start_step=5)
    try:
        for want_step in (5, 6, 7):
            step, batch = next(pipe)
            assert step == want_step
            for k, v in synth_batch(cfg, SHAPE, step, seed=2).items():
                assert batch[k].device.type == "cpu"
                np.testing.assert_array_equal(batch[k].numpy(), v)
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_cuda_without_a_card_raises():
    """Without a card, ``cuda`` raises at every training entry point; no
    step falls back to the CPU."""
    cfg = get_config("llama3.2-1b").reduced()
    api = get_model(cfg)
    opt = make_optimizer()
    with pytest.raises(RuntimeError, match="CUDA card"):
        init_state(api, opt)
    with pytest.raises(RuntimeError, match="CUDA card"):
        make_train_step(api, Runtime(), opt, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA card"):
        Pipeline(cfg, SHAPE)
    state = init_state(api, opt, device="cpu")
    step = make_train_step(api, Runtime(), opt, device="cpu")
    state.model.to(torch.device("meta"))
    with pytest.raises(ValueError, match="the step runs on cpu"):
        step(state, synth_batch(cfg, SHAPE, 0))


def _launch(args, ckpt_dir):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1.5-0.5b", "--reduced", "--steps", "25", "--ckpt-dir",
         ckpt_dir, "--ckpt-every", "10", "--device", "cpu", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_train_driver_crash_restart(tmp_path):
    """``tests/test_launchers.py::test_train_driver_crash_restart`` on the
    port's launcher, on the CPU."""
    ck = str(tmp_path / "ck")
    r1 = _launch(["--crash-at", "15"], ck)
    assert r1.returncode == 42, r1.stderr[-800:]
    assert "committed step 10" in r1.stdout
    assert "[crash] simulated failure after step 15" in r1.stdout
    r2 = _launch([], ck)
    assert r2.returncode == 0, r2.stderr[-800:]
    assert "resumed from committed step 10" in r2.stdout
    assert "done: 15 steps" in r2.stdout
    assert ckpt.committed_steps(ck) == [10, 20]
