"""Synthetic token pipeline with host-side prefetch.

The PyTorch port of the JAX package's ``data/pipeline.py``: deterministic
per-step synthetic batches (seeded, reproducible across restarts: the
checkpoint stores the step, and the pipeline regenerates the exact stream
from it), copied to the device, with a background prefetch queue so host
data generation overlaps device compute.  The draws are numpy's, the JAX
package's own, so :func:`synth_batch` returns its arrays bit for bit.

The token stream is a mixture of Zipf-distributed ids with a repeating
n-gram structure, so the loss actually *decreases* during the example
runs (pure-uniform tokens would pin the loss at ln(V)).  The JAX
package's ``shardings=`` becomes ``device=``: a batch lands whole on one
device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..models.runtime import resolve_device


@dataclass
class DataSpec:
    batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-ish token ids with local n-gram repetition (learnable)."""
    ranks = rng.zipf(1.3, size=shape).astype(np.int64)
    toks = (ranks - 1) % vocab
    # inject repeated bigrams: token[t] == token[t-2] with prob ~ 0.3
    rep = rng.random(shape) < 0.3
    toks[..., 2:] = np.where(rep[..., 2:], toks[..., :-2], toks[..., 2:])
    return toks.astype(np.int32)


def synth_batch(cfg: ModelConfig, shape: ShapeSpec, step: int, *,
                seed: int = 0, batch_override: int | None = None) -> dict:
    """One deterministic synthetic batch (numpy) for (cfg, shape, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    B = batch_override or shape.global_batch
    S = shape.seq_len
    if cfg.family == "encdec":
        S_dec = max(S // cfg.dec_ratio, 8)
        toks = _zipf_tokens(rng, (B, S_dec + 1), cfg.vocab_size)
        return {
            "frames": rng.standard_normal((B, S, cfg.frontend_dim),
                                          dtype=np.float32).astype(np.float16),
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }
    if cfg.family == "vlm":
        S_text = max(S - cfg.n_patches, 8)
        toks = _zipf_tokens(rng, (B, S_text + 1), cfg.vocab_size)
        return {
            "patches": rng.standard_normal((B, cfg.n_patches, cfg.frontend_dim),
                                           dtype=np.float32).astype(np.float16),
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }
    toks = _zipf_tokens(rng, (B, S + 1), cfg.vocab_size)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def to_device(batch: dict, device) -> dict:
    """A batch's arrays as tensors on ``device``: a numpy array is copied
    there once, a tensor already on it is taken as it is, and a ``meta``
    tensor (the dry-run's stand-ins, which hold no data) stays ``meta``."""
    return {k: a if isinstance(a, torch.Tensor) and a.is_meta else
            (torch.from_numpy(np.ascontiguousarray(a))
             if isinstance(a, np.ndarray) else a).to(device)
            for k, a in batch.items()}


class Pipeline:
    """Background-prefetching iterator of (step, batch on ``device``)
    (``cuda`` unless the caller asks for another; without a card that
    raises), two batches made ahead."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, *,
                 device="cuda", seed: int = 0, start_step: int = 0):
        self.cfg, self.shape = cfg, shape
        self.device = resolve_device(device, "Pipeline")
        self.seed = seed
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self._step
        while not self._stop.is_set():
            host = synth_batch(self.cfg, self.shape, step, seed=self.seed)
            while not self._stop.is_set():
                try:
                    self._q.put((step, host), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        step, host = self._q.get()
        return step, to_device(host, self.device)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
