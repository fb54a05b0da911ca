"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of MCCM.

A cell of ``BENCHMARK.json`` names a configuration (``configs/``: a CNN's
layer shapes and an FPGA board, frozen) and a traffic mix (``mixes/``);
each per-layer metric has a reader of its own in ``metrics/``.  ``run.py``
runs one cell; ``reference.py`` is the plain reference that decides
``correct``; ``calibrate.py`` reads the program's and the control's
numbers over many seeds.
"""
