"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``mccm_eval`` holds the fused ⟨pf, ph, pw⟩ parallelism search of the batch
path and the Eq. 1 latency sweep; ``conv_ce`` runs one layer as a compute
engine, a tiled direct convolution whose launch grid is Eq. 1.  A kernel is
built with ``nvcc`` at its first launch (``_nvcc.load``), never at import.

Every kernel wrapper adds one to its entry of the launch count below where
it launches its kernel, and nowhere else; a plain version run on the CPU
counts nothing.
"""
from __future__ import annotations

#: kernel launches since the last ``reset_launches()``, by kernel name
_LAUNCHES = {"parallelism_search": 0, "mccm_latency": 0, "conv_ce": 0}


def launches() -> dict[str, int]:
    """Kernel launches counted since the last :func:`reset_launches`."""
    return dict(_LAUNCHES)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
