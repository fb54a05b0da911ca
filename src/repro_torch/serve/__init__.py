"""Serving fronts of the port: the LM generation engine and the MCCM socket
service.

Lazy attribute resolution keeps the two independent: importing
``EvalServer``/``ServeClient`` (the evaluation service over NDJSON/TCP,
bound to :class:`repro_torch.core.session.Session`) must not pull the
generation engine's model stack, and importing ``ServeEngine`` must not
pull the server.
"""
from __future__ import annotations

_EXPORTS = {
    "GenerationResult": ".engine",
    "ServeEngine": ".engine",
    "EvalServer": ".server",
    "jsonify": ".server",
    "summarize_search": ".server",
    "ServeClient": ".client",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod, __name__), name)
