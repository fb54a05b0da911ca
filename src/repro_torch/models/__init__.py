"""Model zoo of the port: the dense decoder-only transformer LM, for
inference (the other families of the JAX package's ``models/`` are not
ported yet)."""
from .registry import ModelApi, get_model
from .runtime import Runtime

__all__ = ["ModelApi", "Runtime", "get_model"]
