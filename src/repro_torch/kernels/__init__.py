"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``mccm_eval`` holds the fused ⟨pf, ph, pw⟩ parallelism search of the batch
path.  A kernel is built with ``nvcc`` at its first launch
(``_nvcc.load``), never at import.
"""
