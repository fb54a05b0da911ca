"""Workload records: the layer-level inputs to MCCM.

A *layer* here is the unit the paper's equations operate on: a convolution
(standard, depthwise, or pointwise) with its six loop dimensions
(F = filters/out-channels, C = in-channels, KH, KW, OH, OW) plus the sizes
MCCM needs (weights, IFMs, OFMs, MACs).

Everything is counted in *elements*; byte conversion happens at the device
level (``DeviceSpec.wordbytes``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterable, Sequence

# The six disjoint dimensions (DD in Eq. 1) of a convolution loop nest.
DIMS = ("f", "c", "kh", "kw", "oh", "ow")


@dataclass(frozen=True)
class ConvLayer:
    """One convolutional layer's workload record."""

    index: int
    name: str
    kind: str  # 'conv' | 'dw' | 'pw'
    in_ch: int
    out_ch: int
    kh: int
    kw: int
    stride: int
    ih: int  # IFM height
    iw: int  # IFM width
    residual: bool = False  # FMs buffer must hold an extra copy (Eq. 4 note)
    padding: str = "same"

    # ---- derived geometry ----
    @property
    def oh(self) -> int:
        if self.padding == "same":
            return -(-self.ih // self.stride)
        return (self.ih - self.kh) // self.stride + 1

    @property
    def ow(self) -> int:
        if self.padding == "same":
            return -(-self.iw // self.stride)
        return (self.iw - self.kw) // self.stride + 1

    # ---- sizes (elements) ----
    @property
    def ifm_size(self) -> int:
        return self.in_ch * self.ih * self.iw

    @property
    def ofm_size(self) -> int:
        return self.out_ch * self.oh * self.ow

    @property
    def fms_size(self) -> int:
        """IFMs + OFMs (+ residual copy) held concurrently — Eq. 4 term."""
        extra = self.ofm_size if self.residual else 0
        return self.ifm_size + self.ofm_size + extra

    @property
    def weights_size(self) -> int:
        if self.kind == "dw":
            return self.out_ch * self.kh * self.kw
        return self.out_ch * self.in_ch * self.kh * self.kw

    @property
    def macs(self) -> int:
        return self.weights_size * self.oh * self.ow

    # ---- Eq. 1 loop dimensions ----
    def dims(self) -> dict[str, int]:
        c = 1 if self.kind == "dw" else self.in_ch
        return {
            "f": self.out_ch,
            "c": c,
            "kh": self.kh,
            "kw": self.kw,
            "oh": self.oh,
            "ow": self.ow,
        }

    def replace(self, **kw) -> "ConvLayer":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Network:
    """A CNN as MCCM sees it: an ordered list of conv layers."""

    name: str
    layers: tuple[ConvLayer, ...]

    def __post_init__(self):
        for i, l in enumerate(self.layers):
            if l.index != i:
                raise ValueError(f"layer {l.name} has index {l.index}, expected {i}")

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, i):
        return self.layers[i]

    def __iter__(self):
        return iter(self.layers)

    # ---- aggregates ----
    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def total_weights(self) -> int:
        return sum(l.weights_size for l in self.layers)

    def slice(self, lo: int, hi: int) -> Sequence[ConvLayer]:
        """Layers lo..hi inclusive (0-based)."""
        return self.layers[lo : hi + 1]


def make_network(name: str, specs: Iterable[dict]) -> Network:
    """Build a Network from plain dicts (used by the CNN zoo)."""
    layers = []
    for i, s in enumerate(specs):
        layers.append(ConvLayer(index=i, **s))
    return Network(name=name, layers=tuple(layers))
