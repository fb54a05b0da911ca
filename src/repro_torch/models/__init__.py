"""Model zoo of the port, for inference: every family of the JAX
package's ``models/`` (dense and MoE transformer LMs, Mamba2 and the
Zamba2 hybrid, the Whisper-style enc-dec, the InternVL2-style VLM)."""
from .registry import ModelApi, get_model
from .runtime import Runtime

__all__ = ["ModelApi", "Runtime", "get_model"]
