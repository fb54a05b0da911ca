"""A compute engine as a kernel: a tiled direct convolution whose launch
grid is the paper's Eq. 1 (CUDA C++ in ``csrc/conv_ce.cu``, the plain
PyTorch version in ``ref.py``)."""
from .ops import (conv_ce, conv_ce_cuda, grid_size,  # noqa: F401
                  predicted_cycles)
from .ref import conv_ce_ref, conv_ref  # noqa: F401
