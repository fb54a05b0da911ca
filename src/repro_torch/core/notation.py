"""The paper's multiple-CE accelerator notation (§III-B).

Grammar (1-based layer/CE indices in the surface syntax)::

    accel    := '{' entry (',' entry)* '}'
    entry    := layers ':' ces
    layers   := 'L' idx | 'L' idx '-' ('L'? idx | 'Last')
    ces      := 'CE' idx | 'CE' idx '-' 'CE' idx

Examples from the paper:
    Segmented    {L1-L4:CE1, L5-L6:CE2, L7-L9:CE3, L10-L12:CE4}
    SegmentedRR  {L1-Last:CE1-CE4}
    Hybrid       {L1:CE1, L2:CE2, L3:CE3, L4-Last:CE4}
"""
from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class SegmentSpec:
    """Layers [layer_lo, layer_hi] on CEs [ce_lo, ce_hi] (0-based, inclusive)."""

    layer_lo: int
    layer_hi: int
    ce_lo: int
    ce_hi: int

    @property
    def pipelined(self) -> bool:
        return self.ce_hi > self.ce_lo

    @property
    def n_layers(self) -> int:
        return self.layer_hi - self.layer_lo + 1

    @property
    def n_ces(self) -> int:
        return self.ce_hi - self.ce_lo + 1


@dataclass(frozen=True)
class AcceleratorSpec:
    name: str
    segments: tuple[SegmentSpec, ...]
    inter_segment_pipelining: bool = True

    @property
    def n_ces(self) -> int:
        return max(s.ce_hi for s in self.segments) + 1

    def validate(self, n_layers: int) -> None:
        cover = []
        for s in self.segments:
            if not (0 <= s.layer_lo <= s.layer_hi < n_layers):
                raise ValueError(f"segment {s} out of range for {n_layers} layers")
            if s.ce_lo > s.ce_hi or s.ce_lo < 0:
                raise ValueError(f"bad CE range in {s}")
            cover.extend(range(s.layer_lo, s.layer_hi + 1))
        if cover != list(range(n_layers)):
            raise ValueError(
                "segments must cover all layers exactly once, in order "
                f"(got {len(cover)} assignments for {n_layers} layers)"
            )


_ENTRY = re.compile(
    r"^L(?P<lo>\d+)(?:-(?:L?(?P<hi>\d+)|(?P<last>Last)))?"
    r":CE(?P<clo>\d+)(?:-CE(?P<chi>\d+))?$",
    re.IGNORECASE,
)


def parse(text: str, n_layers: int, name: str = "custom",
          inter_segment_pipelining: bool = True) -> AcceleratorSpec:
    """Parse the paper's notation into an AcceleratorSpec."""
    body = text.strip()
    if body.startswith("{") and body.endswith("}"):
        body = body[1:-1]
    segments = []
    for raw in body.split(","):
        entry = raw.strip().replace(" ", "")
        if not entry:
            continue
        m = _ENTRY.match(entry)
        if not m:
            raise ValueError(f"cannot parse entry {raw!r}")
        lo = int(m.group("lo")) - 1
        if m.group("last"):
            hi = n_layers - 1
        elif m.group("hi"):
            hi = int(m.group("hi")) - 1
        else:
            hi = lo
        clo = int(m.group("clo")) - 1
        chi = int(m.group("chi")) - 1 if m.group("chi") else clo
        segments.append(SegmentSpec(lo, hi, clo, chi))
    spec = AcceleratorSpec(
        name=name,
        segments=tuple(segments),
        inter_segment_pipelining=inter_segment_pipelining,
    )
    spec.validate(n_layers)
    return spec


def format_spec(spec: AcceleratorSpec, n_layers: int | None = None) -> str:
    """Inverse of :func:`parse` (layer/CE indices back to 1-based)."""
    parts = []
    for s in spec.segments:
        if n_layers is not None and s.layer_hi == n_layers - 1 and s.layer_lo != s.layer_hi:
            layers = f"L{s.layer_lo + 1}-Last"
        elif s.layer_lo == s.layer_hi:
            layers = f"L{s.layer_lo + 1}"
        else:
            layers = f"L{s.layer_lo + 1}-L{s.layer_hi + 1}"
        ces = f"CE{s.ce_lo + 1}" if not s.pipelined else f"CE{s.ce_lo + 1}-CE{s.ce_hi + 1}"
        parts.append(f"{layers}:{ces}")
    return "{" + ", ".join(parts) + "}"
