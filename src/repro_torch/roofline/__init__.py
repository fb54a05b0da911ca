"""Port of the JAX package's ``roofline/``: roofline analysis of walked
steps on the H100."""
from .analysis import CellRoofline, analyze_cell, load_artifacts  # noqa: F401
from .constants import HBM_BW, LINK_BW, PEAK_BF16  # noqa: F401
