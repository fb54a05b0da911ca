"""Port of the JAX package's ``tpu/chip.py``: the H100 card and node
model.

The FPGA DeviceSpec analog one level up: where MCCM distributes DSPs/BRAM
among CEs, the step model distributes cards/HBM among parallelism axes.
Every figure names its source.  The data sheet's rates are those of an
H100 SXM at its 700 W limit; a card set to a lower ``power.limit`` runs
slower under load, so a figure measured against these peaks carries the
card's limit beside it.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str = "h100-sxm"
    #: dense tensor-core rate in bf16 (NVIDIA H100 data sheet, SXM, 700 W)
    peak_flops_bf16: float = 989e12
    #: f32 outside the tensor cores (the same sheet); the port keeps TF32
    #: off, so an f32 product runs at this rate
    peak_flops_f32: float = 67e12
    #: HBM3 bandwidth (the same sheet)
    hbm_bytes_per_s: float = 3.35e12
    #: ``torch.cuda.get_device_properties(0).total_memory`` of an H100 80GB
    #: HBM3 (read on the card, ``chip_smoke.py`` phase 18 (a))
    hbm_capacity: int = 85_017_493_504
    #: NVLink 4: 18 links of 25 GB/s each way, 450 GB/s each way in all
    #: (Hopper architecture white paper); the TPU model's ICI link x links
    link_bytes_per_s: float = 25e9
    links: int = 18
    #: SMs, and the shared memory one block may opt in to
    #: (``multi_processor_count``, ``shared_memory_per_block_optin``; read
    #: on the card, phase 18 (a))
    sms: int = 132
    smem_bytes_per_block: int = 232_448
    #: rows of one ``wgmma`` tile; a 128-byte swizzled K step holds 64
    #: bf16 (the TPU model's 128-wide MXU tile)
    mma_tile: int = 64

    def mma_pad(self, d: int) -> int:
        """Eq. 1's ceil-div underutilisation, tensor-core form: a dim is
        processed in ``mma_tile``-wide tiles, so a dim of d costs
        ceil(d / tile) * tile lanes."""
        t = self.mma_tile
        return -(-max(d, 1) // t) * t


H100 = ChipSpec()


@dataclass(frozen=True)
class PodSpec:
    """An HGX H100 node of 8 cards joined all to all by NVLink, and
    ``nodes`` of them joined by InfiniBand."""

    chip: ChipSpec = H100
    chips: int = 8                       # one HGX H100 board
    nodes: int = 1
    #: one ConnectX-7 400 Gb/s NDR InfiniBand port a card (NVIDIA DGX H100
    #: data sheet): 50 GB/s each way, the TPU model's inter-pod DCI figure
    network_bytes_per_s: float = 50e9

    @property
    def total_chips(self) -> int:
        return self.chips * self.nodes

    @property
    def total_hbm(self) -> int:
        return self.total_chips * self.chip.hbm_capacity


SINGLE_NODE = PodSpec()
MULTI_NODE = PodSpec(nodes=2)
