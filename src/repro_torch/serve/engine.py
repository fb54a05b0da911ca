"""Batched serving engine: prefill + decode loop over a request batch.

The PyTorch port of the JAX package's ``serve/engine.py``:

* ``prefill`` runs the whole (padded) prompt batch once and builds the KV
  (or SSM-state) cache with headroom ``max_new_tokens``; the VLM's patches
  and the enc-dec's frames come in ``extra_inputs``;
* ``decode`` runs single-token steps, each writing its position (or the
  new recurrent state) into the cache in place;
* sampling: greedy (argmax, first index on ties) or temperature, drawn from
  a ``torch.Generator`` seeded with ``seed`` (its draws are not
  ``jax.random``'s); stop tokens honoured per slot;
* static batching: requests are right-aligned and left-padded with token
  0 to the batch's longest prompt, unmasked, exactly as the JAX package
  does it.

The engine runs on one explicit device: ``cuda`` unless the caller passes
``device="cpu"``, and asked for ``cuda`` without a visible card it raises
instead of running on the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.convert import to_tensor
from ..models.registry import get_model
from ..models.runtime import Runtime, resolve_device


@dataclass
class GenerationResult:
    tokens: list[list[int]]
    n_prefill: int
    n_steps: int
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        n = sum(len(t) for t in self.tokens)
        return n / self.decode_s if self.decode_s else float("inf")


@dataclass
class ServeEngine:
    cfg: ModelConfig
    rt: Runtime = field(default_factory=Runtime)
    temperature: float = 0.0
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device, "ServeEngine")
        self.api = get_model(self.cfg)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits, gen: torch.Generator):
        logits = logits[:, -1, :self.cfg.vocab_size]
        if self.temperature <= 0.0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits / self.temperature, -1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def generate(self, model, prompts: list[list[int]], *,
                 max_new_tokens: int = 32,
                 stop_token: int | None = None,
                 extra_inputs: dict | None = None) -> GenerationResult:
        """Greedy or sampled generation for ``prompts``.  ``extra_inputs``
        (numpy arrays or tensors, e.g. ``{"patches": ...}`` for the VLM,
        ``{"frames": ...}`` for the enc-dec) go to the engine's device and
        into prefill's batch beside the tokens."""
        B = len(prompts)
        Lp = max(len(p) for p in prompts)
        toks = np.zeros((B, Lp), np.int64)
        for i, p in enumerate(prompts):          # right-align (causal LM)
            toks[i, Lp - len(p):] = p
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        for k, v in (extra_inputs or {}).items():
            batch[k] = (v.to(self.device) if isinstance(v, torch.Tensor)
                        else to_tensor(v, self.device))
        max_len = Lp + max_new_tokens + 1

        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.api.prefill(model, batch, self.rt,
                                         max_len=max_len)
        self._sync()
        t1 = time.perf_counter()

        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        out = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        tok = self._sample(logits, gen)
        steps = 0
        for _ in range(max_new_tokens):
            t_host = tok.cpu().numpy()
            for i in range(B):
                if not done[i]:
                    out[i].append(int(t_host[i]))
                    if stop_token is not None and t_host[i] == stop_token:
                        done[i] = True
            steps += 1
            if done.all():
                break
            logits, cache = self.api.decode_step(model, cache, tok[:, None],
                                                 self.rt)
            tok = self._sample(logits, gen)
        self._sync()
        t2 = time.perf_counter()
        return GenerationResult(tokens=out, n_prefill=Lp, n_steps=steps,
                                prefill_s=t1 - t0, decode_s=t2 - t1)
