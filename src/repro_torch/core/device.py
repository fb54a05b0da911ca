"""Device abstraction under MCCM.

The paper instantiates the model on FPGA boards (PEs = DSPs, on-chip = BRAM,
off-chip = DDR).  A copy of the JAX package's ``core/device.py``: the port
keeps its own, so that it imports nothing of that package.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceSpec:
    """Resource budget the Builder distributes among CEs."""

    name: str
    pes: int                    # number of MAC units (DSPs on FPGA)
    on_chip_bytes: int          # BRAM capacity
    off_chip_gbps: float        # DRAM bandwidth, GB/s
    clock_hz: float = 2.0e8     # 200 MHz, typical of the cited HLS designs
    wordbytes: int = 1          # int8 weights/activations (FiBHA-style)

    @property
    def off_chip_bytes_per_cycle(self) -> float:
        return self.off_chip_gbps * 1e9 / self.clock_hz

    def macs_per_second(self) -> float:
        return self.pes * self.clock_hz


def mib(x: float) -> int:
    return int(x * 1024 * 1024)
