"""FPGA boards from paper Table II."""
from __future__ import annotations

from ..core.device import DeviceSpec, mib

BOARDS = {
    "zc706": DeviceSpec("zc706", pes=900, on_chip_bytes=mib(2.4), off_chip_gbps=3.2),
    "vcu108": DeviceSpec("vcu108", pes=768, on_chip_bytes=mib(7.6), off_chip_gbps=19.2),
    "vcu110": DeviceSpec("vcu110", pes=1800, on_chip_bytes=mib(4.0), off_chip_gbps=19.2),
    "zcu102": DeviceSpec("zcu102", pes=2520, on_chip_bytes=mib(16.6), off_chip_gbps=19.2),
}

BOARD_NAMES = tuple(BOARDS)

# the board used when none is named — the paper's main DSE target (XCp
# custom-family exploration, Fig. 10, runs on VCU110)
DEFAULT_BOARD = "vcu110"


def get_board(name: str = DEFAULT_BOARD) -> DeviceSpec:
    if name not in BOARDS:
        raise KeyError(f"unknown board {name!r}; known: {sorted(BOARDS)}")
    return BOARDS[name]
