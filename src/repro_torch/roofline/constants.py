"""Port of the JAX package's ``roofline/constants.py`` (a v5e): the
roofline terms' hardware constants, read from the port's H100 spec."""
from ..gpu.chip import H100

PEAK_BF16 = H100.peak_flops_bf16         # 989e12 FLOP/s per card
HBM_BW = H100.hbm_bytes_per_s            # 3.35e12 B/s per card
LINK_BW = H100.link_bytes_per_s          # 25e9 B/s per NVLink link
LINKS = H100.links                       # 18
HBM_CAP = H100.hbm_capacity              # total_memory of an H100 80GB
