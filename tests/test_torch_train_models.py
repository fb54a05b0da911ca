"""The port's training losses and gradients against the JAX package's,
family by family, and the committed ``golden_train.npz``.

Each reduced family in f32 (Llama, Granite MoE, Mamba2, the Zamba2
hybrid, Whisper, InternVL2) runs on the JAX package's weights of
``init(jax.random.key(0))`` (carried across by ``from_jax``) and the
``synth_batch`` of step 0, through ``get_model(cfg).loss`` under autograd;
the JAX side is ``jax.value_and_grad(api.loss)``, computed once a process
(``torch_golden.compute_golden_train``, the golden file's own values).
Llama, Zamba2, Whisper and InternVL2 take the chunked attention path, so
their gradients go through ``layers.FlashAttention``'s backward.

Tolerances: the loss within ``LOSS_ATOL`` (1e-5) of the JAX package's;
every gradient leaf element by element within ``GRAD_RTOL`` (5e-5) of
that leaf's own scale (its largest |value|, with no floor: the leaves'
scales run from 1.8e-3, Whisper's ``enc_pos``, to 1.3, Zamba2's
embedding table), and within ``GRAD_RTOL`` relatively.  The two packages
add the same f32 products in other orders; the worst leaf parts by
1.53e-5 of its scale (Zamba2's ``groups/mixer/in_proj``), the rest by
1.4e-5 or less.  ``test_grad_check_catches_planted_fault`` holds the
check to two faults that leave the loss as it is: the load-balance
loss's gradient left out of Granite's router, and Mamba2's step sizes cut
off from the gradient.  Remat recomputes the same ops on the same
inputs, so it changes no bit of the loss or the gradients.
"""
from __future__ import annotations

import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import moe, ssm
from repro_torch.models.convert import flatten, from_jax, to_jax, unflatten
from repro_torch.models.registry import get_model
from repro_torch.models.runtime import Runtime
from torch_golden import (DATA, GOLDEN_TRAIN, TRAIN_ARCHS,
                          compute_golden_train, train_case)
from torch_lm_cases import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOSS_ATOL = 1e-5
GRAD_RTOL = 5e-5
ARCHS = tuple(TRAIN_ARCHS)
#: the runtime variants each family is held to the JAX package's values
#: under: plain, remat a layer, and remat groups of 2 with a loss chunk
#: that does not divide the sequence (12 of 32)
VARIANTS = {"plain": {}, "remat": {"remat": True},
            "remat_group_chunk": {"remat": True, "remat_group": 2,
                                  "loss_chunk": 12}}


@functools.lru_cache(maxsize=None)
def jax_values() -> dict:
    return compute_golden_train()


@functools.lru_cache(maxsize=None)
def case(arch: str):
    """(config, model on the CPU, batch as tensors, runtime fields) of an
    arch, the model from the JAX package's params."""
    cfg, _, rt_kw = train_case(get_config, arch)
    pfile, prefix, _, _ = TRAIN_ARCHS[arch]
    with np.load(f"{DATA}/{pfile}") as z:
        params = unflatten({k: z[k] for k in z.files}, prefix)
    model = from_jax(params, cfg, device="cpu").requires_grad_(True)
    want = jax_values()
    batch = {k[len(f"{arch}/batch/"):]: torch.from_numpy(np.asarray(v))
             for k, v in want.items() if k.startswith(f"{arch}/batch/")}
    return cfg, model, batch, rt_kw


def loss_and_grads(arch: str, **rt_kw):
    """The port's (loss, metrics, flat JAX-layout gradients) of an arch
    under its runtime with ``rt_kw`` added."""
    cfg, model, batch, base = case(arch)
    loss, metrics = get_model(cfg).loss(model, batch,
                                        Runtime(**{**base, **rt_kw}))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    return (loss.item(), {k: v.item() for k, v in metrics.items()},
            flatten(to_jax(dict(zip(names, grads)))))


def want_grads(arch: str) -> dict:
    pre = f"{arch}/grads/"
    return {k[len(pre):]: v for k, v in jax_values().items()
            if k.startswith(pre)}


def assert_grads_close(got: dict, want: dict, what: str) -> None:
    """Every leaf within ``GRAD_RTOL`` of its own scale and relatively;
    a failure names every leaf out of bounds, with its scale and its
    largest error."""
    assert sorted(got) == sorted(want), what
    bad = []
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        assert got[k].shape == w.shape, f"{what} {k}"
        scale = float(np.abs(w).max(initial=0.0))
        d = np.abs(got[k] - w)
        if (d > GRAD_RTOL * (scale + np.abs(w))).any():
            bad.append(f"{k} (scale {scale:.3e}, error "
                       f"{float(d.max()):.3e})")
    assert not bad, f"{what}: " + ", ".join(bad)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_jax(arch, variant):
    want = jax_values()
    loss, metrics, grads = loss_and_grads(arch, **VARIANTS[variant])
    pre = f"{arch}/"
    assert abs(loss - float(want[pre + "loss"])) <= LOSS_ATOL
    assert abs(metrics["nll"] - float(want[pre + "nll"])) <= LOSS_ATOL
    assert abs(metrics["aux"] - float(want[pre + "aux"])) <= LOSS_ATOL
    assert_grads_close(grads, want_grads(arch), f"{arch} {variant}")


def _aux_detached(monkeypatch):
    """The MoE router's load-balance loss enters the loss's value but not
    its gradient."""
    route = moe._route

    def planted(*a, **kw):
        eidx, gates, aux = route(*a, **kw)
        return eidx, gates, aux.detach()
    monkeypatch.setattr(moe, "_route", planted)


def _dt_detached(monkeypatch):
    """The SSD scan's step sizes carry no gradient (``dt_bias`` gets none,
    and ``in_proj``'s dt columns none)."""
    scan = ssm.ssd_chunked

    def planted(xh, dt, *a, **kw):
        return scan(xh, dt.detach(), *a, **kw)
    monkeypatch.setattr(ssm, "ssd_chunked", planted)


#: a planted fault -> (arch, how it is planted, a leaf the check must name)
FAULTS = {
    "router_without_aux": ("granite-moe-1b-a400m", _aux_detached,
                           "layers/moe/router"),
    "ssd_dt_without_grad": ("mamba2-370m", _dt_detached,
                            "tail/mixer/dt_bias"),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_grad_check_catches_planted_fault(fault, monkeypatch):
    """A fault that drops one term of the gradient and leaves the loss as
    it is: the loss still meets the JAX package's, and the gradient check
    fails, naming the leaf."""
    arch, plant, leaf = FAULTS[fault]
    plant(monkeypatch)
    loss, _, grads = loss_and_grads(arch)
    assert abs(loss - float(jax_values()[f"{arch}/loss"])) <= LOSS_ATOL
    with pytest.raises(AssertionError, match=leaf):
        assert_grads_close(grads, want_grads(arch), fault)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
def test_remat_changes_no_bit(arch):
    """Remat (per layer, or by groups) recomputes the same ops on the
    same inputs: the loss and every gradient equal the plain run's bit
    for bit."""
    loss, _, grads = loss_and_grads(arch)
    for kw in ({"remat": True}, {"remat": True, "remat_group": 2}):
        l2, _, g2 = loss_and_grads(arch, **kw)
        assert l2 == loss, kw
        for k, g in grads.items():
            np.testing.assert_array_equal(g2[k], g, err_msg=f"{kw} {k}")


def test_chunked_attention_carries_the_gradient(monkeypatch):
    """Llama's case takes the chunked path: one chunked call a layer in
    the forward, one more a layer under remat's recompute, and the
    Function's backward once a layer."""
    cfg, model, batch, rt_kw = case("llama3.2-1b")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = L.flash_attention, L.flash_bwd

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(L, "flash_attention", count("fwd", fwd))
    monkeypatch.setattr(L, "flash_bwd", count("bwd", bwd))
    loss, _ = get_model(cfg).loss(model, batch,
                                  Runtime(**rt_kw, remat=True))
    assert calls == {"fwd": cfg.n_layers, "bwd": 0}
    loss.backward()
    model.zero_grad(set_to_none=True)
    assert calls == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}


def test_golden_train_is_current():
    """The committed file equals what the JAX package computes: the
    batches exactly, the loss and gradients within 1e-6 of their scale
    (a different CPU's vector unit)."""
    want = jax_values()
    with np.load(GOLDEN_TRAIN) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if w.dtype.kind in "USO" or "/batch/" in k:
            np.testing.assert_array_equal(g, w, err_msg=k)
            assert g.dtype == w.dtype, k
        else:
            scale = max(1.0, float(np.abs(w).max(initial=0.0)))
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=k)


def test_golden_train_params_are_the_reused_files():
    """Each arch's params stand in the golden serving file it names, under
    the config's overrides there, and build the config's model."""
    with np.load(GOLDEN_TRAIN) as z:
        for arch in ARCHS:
            pfile = str(z[f"{arch}/params_file"])
            prefix = str(z[f"{arch}/params_prefix"])
            overrides = json.loads(str(z[f"{arch}/overrides"]))
            with np.load(f"{DATA}/{pfile}") as p:
                if pfile == "golden_lm_families.npz":
                    assert json.loads(str(p[f"{arch}/overrides"])) == \
                        overrides, arch
                params = unflatten({k: p[k] for k in p.files}, prefix)
            cfg, _, _ = train_case(get_config, arch)
            model = from_jax(params, cfg, device="cpu")
            assert sum(1 for g in z.files
                       if g.startswith(f"{arch}/grads/")) == \
                len(flatten(params)), arch
            del model


@pytest.mark.parametrize("arch", ARCHS)
def test_port_meets_golden_train(arch):
    """``chip_smoke.py`` phase 17 (b)'s check, made on the CPU: the
    port's loss and gradients from the golden file alone."""
    out = chip_smoke()._train_golden_case(arch, torch.device("cpu"))
    assert out["loss_abs_err"] <= LOSS_ATOL
    assert out["grad_excess"] <= 0.0
