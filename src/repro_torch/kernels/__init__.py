"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``mccm_eval`` holds the fused ⟨pf, ph, pw⟩ parallelism search of the batch
path and the Eq. 1 latency sweep; ``conv_ce`` runs one layer as a compute
engine, a tiled direct convolution whose launch grid is Eq. 1;
``flash_attn`` is the LM serving path's attention past 2048 positions
(prefill, and the enc-dec's cross-attention in every decode step).  A kernel is
built with ``nvcc`` at its first launch (``_nvcc.load``), never at import.

Every kernel wrapper adds one to its entry of the launch count below where
it launches its kernel, and nowhere else; a plain version run on the CPU
counts nothing.  A wrapper that has to copy an input before its kernel can
read it (``flash_attn.ops.readable``; a non-contiguous ``par`` of
``mccm_latency``) counts each copy in ``copies()``.
"""
from __future__ import annotations

#: kernel launches since the last ``reset_launches()``, by kernel name
_LAUNCHES = {"parallelism_search": 0, "mccm_latency": 0, "conv_ce": 0,
             "flash_fwd": 0}
#: input copies a wrapper made before a launch, by kernel name
_COPIES = {"flash_fwd": 0, "mccm_latency": 0}


def launches() -> dict[str, int]:
    """Kernel launches counted since the last :func:`reset_launches`."""
    return dict(_LAUNCHES)


def copies() -> dict[str, int]:
    """Input copies counted since the last :func:`reset_launches`."""
    return dict(_COPIES)


def reset_launches() -> None:
    """Set every launch count and every copy count to 0."""
    for counts in (_LAUNCHES, _COPIES):
        for k in counts:
            counts[k] = 0
