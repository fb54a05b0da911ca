"""FlashAttention forward as a kernel: the online-softmax recurrence over
KV tiles with causal, sliding-window and padded-KV masks (CUDA C++:
``csrc/flash_fwd_bf16.cu`` for bf16, on the tensor cores, and
``csrc/flash_fwd.cu`` for f32; the plain PyTorch versions in ``ref.py``)."""
from .ops import flash_attention, flash_attention_cuda  # noqa: F401
from .ref import attention_ref, flash_fwd_ref  # noqa: F401
