from .archs import ARCH_NAMES, hybrid, make_arch, segmented, segmented_rr
from .boards import BOARD_NAMES, BOARDS, get_board

__all__ = [
    "ARCH_NAMES",
    "BOARD_NAMES",
    "BOARDS",
    "get_board",
    "hybrid",
    "make_arch",
    "segmented",
    "segmented_rr",
]
