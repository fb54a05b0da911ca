"""Port of the JAX package's ``tpu/hlo_stats.py``: statistics of a
finished walk (collective bytes, the op census, the hand kernels).

The JAX module scans compiled HLO text; here the walk
(``op_walk.OpWalk``) has already seen every op, so each function reads
what it counted.  Byte conventions are the JAX module's:

* ``operand_bytes`` -- the input bytes of each collective op, per device
  (what the op touches);
* ``wire_bytes`` -- the ring algorithm's bytes a device actually moves:
  all-reduce 2x(n-1)/n, all-gather/reduce-scatter/all-to-all (n-1)/n,
  collective-permute (a broadcast, send or receive here) 1x.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from .op_walk import OpWalk, WalkCosts


@dataclass
class CollectiveStats:
    operand_bytes: dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    wire_bytes: dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_operand(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_wire(self) -> int:
        return sum(self.wire_bytes.values())

    def as_dict(self) -> dict:
        return {
            "operand_bytes": dict(self.operand_bytes),
            "wire_bytes": dict(self.wire_bytes),
            "counts": dict(self.counts),
            "total_operand": self.total_operand,
            "total_wire": self.total_wire,
        }


def _costs(walk: OpWalk | WalkCosts) -> WalkCosts:
    return walk.costs() if isinstance(walk, OpWalk) else walk


def collective_stats(walk: OpWalk | WalkCosts) -> CollectiveStats:
    """The collectives a walk saw, by kind; sizes are per device."""
    c = _costs(walk)
    stats = CollectiveStats()
    for kind, n in c.coll_count.items():
        stats.counts[kind] = int(n)
        stats.operand_bytes[kind] = int(c.coll_operand.get(kind, 0))
        stats.wire_bytes[kind] = int(c.coll_wire.get(kind, 0))
    return stats


def op_census(walk: OpWalk | WalkCosts, top: int = 20
              ) -> list[tuple[str, int]]:
    """The aten ops a walk counted, most frequent first (a hand kernel's
    charge is not among them: see :func:`fusion_count`)."""
    counts = _costs(walk).census
    return sorted(((k, int(v)) for k, v in counts.items()),
                  key=lambda kv: -kv[1])[:top]


def fusion_count(walk: OpWalk | WalkCosts) -> int:
    """The hand kernels' charges in a walk: the port's fused ops, as XLA's
    fusions are the JAX module's."""
    return int(sum(_costs(walk).charges.values()))
