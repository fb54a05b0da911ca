"""Port of the JAX package's ``tpu/`` (which has no ``__init__``): the
analytical step model on one H100.

``chip`` holds the card's figures (``H100``), ``op_walk`` counts what an
eager step runs (the twin of the HLO walk) and ``op_stats`` summarises a
walk, ``cost_model`` scores an (arch x shape x plan) cell analytically and
``autoplan`` ranks the one-device plans with it.
"""
