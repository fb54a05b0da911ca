"""PyTorch + CUDA port of the MCCM reproduction (the JAX package ``repro``
is the reference it is held against).

It imports torch and numpy, never jax and nothing of ``repro``.  The front
door is :mod:`repro_torch.api`.
"""
