"""The Builder's parallelism candidates (paper §IV-A).

Only ``CANDIDATES_DEFAULT`` is here so far: the batch path needs the
candidate list, and the scalar Builder that the JAX package keeps beside it
(``CE``, ``best_parallelism``, the block evaluators) is still to be ported.
"""
from __future__ import annotations

#: ⟨pf, ph, pw⟩ values the parallelism search picks from, ascending
CANDIDATES_DEFAULT = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                      192, 256, 384, 512)
