"""PyTorch + CUDA port of the MCCM reproduction (the JAX package ``repro``
is the reference it is held against).

It imports torch and numpy, never jax and nothing of ``repro``.  The front
door is :mod:`repro_torch.api`::

    from repro_torch.api import Session

(also re-exported lazily here: ``repro_torch.Session``).  Runnable
examples of every entry point are under ``examples/torch/``.
"""
from __future__ import annotations

# Everything re-exports lazily (PEP 562): `import repro_torch` loads no
# torch until a session (or the core package) is actually used.
_LAZY = {
    "EvalConfig": ".core.session",
    "Session": ".core.session",
    "SessionStats": ".core.session",
    "default_session": ".core.session",
}

# subpackages resolvable as attributes without eager import
_LAZY_MODULES = {"telemetry": ".telemetry"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        value = getattr(importlib.import_module(_LAZY[name], __name__), name)
        globals()[name] = value        # cache for subsequent lookups
        return value
    if name in _LAZY_MODULES:
        import importlib
        value = importlib.import_module(_LAZY_MODULES[name], __name__)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["EvalConfig", "Session", "SessionStats", "default_session",
           "telemetry"]
