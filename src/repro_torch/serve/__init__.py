"""Serving front of the port: the LM generation engine.  (The JAX
package's MCCM socket service, ``serve/server.py``, is not ported yet.)"""
from .engine import GenerationResult, ServeEngine

__all__ = ["GenerationResult", "ServeEngine"]
