"""Model zoo of the port, for serving and training: every family of the
JAX package's ``models/`` (dense and MoE transformer LMs, Mamba2 and the
Zamba2 hybrid, the Whisper-style enc-dec, the InternVL2-style VLM), on
one device or on a mesh."""
from .registry import (ModelApi, cache_specs, get_model, input_specs,
                       param_specs)
from .runtime import LOCAL, Runtime

__all__ = ["LOCAL", "ModelApi", "Runtime", "cache_specs", "get_model",
           "input_specs", "param_specs"]
