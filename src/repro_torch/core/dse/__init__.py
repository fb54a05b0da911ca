"""Design encoding and samplers of the port (the single-model part)."""
from .encoding import (NC, NS, DesignBatch, decode_batch,  # noqa: F401
                       decode_design, encode_specs, validate_batch)
from .samplers import sample_custom, sample_mixed  # noqa: F401
