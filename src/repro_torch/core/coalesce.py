"""Batch-size-aware coalescing for the megabatch drain of ``Session.submit``.

The port's copy of the JAX package's ``core/coalesce.py`` (pure Python, the
same plans for the same streams).  ``Session.submit`` queues requests of
very different shapes: a point probe of one design next to a 10k-design
sweep, across CNNs and boards.  The drain plans them:

* **merge** -- requests that share evaluation state (the same memoized
  ``NetTables`` and the same board) pack into shared chunks, so k tiny
  probes cost one padded chunk (one search-kernel launch on the card)
  instead of k;
* **split** -- a request larger than the session's chunk splits at chunk
  boundaries;
* **bound** -- every chunk pads to the ladder ``batch_eval._bucket``
  pads spec lists to (``tile x ndevices x 2^k``, capped at ``chunk``), so
  the plan mints no chunk shape the evaluate path does not already use.

The planner is a pure function of ``(group, size)`` pairs: deterministic
next-fit packing that keeps each request's specs in order, so the
exactly-once, ordering and padding guarantees are testable without a
session.  :class:`ArrivalEstimator` is the adaptive linger policy on top:
the drain waits ~2 observed inter-arrival times for peers, never more than
the configured cap.  ``ndevices`` is the session's mesh width
(``core.shard.EvalMesh``; 1 unless the mesh is sharded), so every chunk
splits into equal shards.
"""
from __future__ import annotations

from dataclasses import dataclass


def ladder_pad(rows: int, chunk: int, tile: int, ndevices: int = 1) -> int:
    """Padded size of a ``rows``-design chunk: the smallest ladder shape
    (``tile x ndevices x 2^k``) holding it, capped at ``chunk``.  Mirrors
    ``batch_eval._bucket``, so the plan's shapes are the evaluate path's."""
    if rows > chunk:
        raise ValueError(f"chunk rows {rows} exceed the compiled chunk "
                         f"size {chunk}")
    n = tile * max(int(ndevices), 1)
    while n < rows:
        n *= 2
    return min(n, chunk)


@dataclass(frozen=True)
class Part:
    """One request's contribution to a chunk: specs ``[lo, hi)`` of
    request ``req`` (an index into the planner's input order)."""

    req: int
    lo: int
    hi: int

    def __len__(self) -> int:
        return self.hi - self.lo


@dataclass(frozen=True)
class Chunk:
    """One padded dispatch unit: same-group parts, packed in order."""

    group: object
    parts: tuple[Part, ...]
    rows: int                    # sum of part lengths
    pad: int                     # padded rows (ladder shape, <= chunk)


@dataclass(frozen=True)
class Plan:
    """The megabatch plan: chunks in execution order plus summary
    counters (``merges`` = requests sharing a chunk with another,
    ``splits`` = requests spanning more than one chunk)."""

    chunks: tuple[Chunk, ...]
    merges: int
    splits: int

    @property
    def shared_pad(self) -> int:
        """The largest chunk pad of the megabatch (the JAX package pads
        every chunk to it; the port evaluates each at its own ``pad``)."""
        return max((c.pad for c in self.chunks), default=0)


def plan_megabatch(requests, chunk: int, tile: int,
                   ndevices: int = 1) -> Plan:
    """Plan chunks for ``requests``, a sequence of ``(group, size)`` pairs
    in queue order (``group`` is hashable; requests merge only within a
    group).

    Deterministic next-fit packing: each request's specs append to its
    group's open chunk, splitting at the ``chunk`` boundary.  Every
    (request, spec) position appears exactly once; a request's parts come
    in spec order; a chunk holds one group; ``rows <= pad <= chunk`` with
    ``pad`` on the ladder."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    open_parts: dict[object, list[Part]] = {}
    open_rows: dict[object, int] = {}
    order: list[object] = []          # group first-appearance order
    closed: list[Chunk] = []
    split_reqs: set[int] = set()

    def close(group) -> None:
        parts = open_parts.pop(group, [])
        rows = open_rows.pop(group, 0)
        if parts:
            closed.append(Chunk(group, tuple(parts), rows,
                                ladder_pad(rows, chunk, tile, ndevices)))

    for i, (group, size) in enumerate(requests):
        size = int(size)
        if size < 1:
            raise ValueError(f"request {i} has size {size}; empty "
                             f"requests are rejected at submit()")
        if group not in open_parts:
            open_parts[group] = []
            open_rows[group] = 0
            order.append(group)
        lo = 0
        while lo < size:
            space = chunk - open_rows[group]
            if space == 0:
                close(group)
                open_parts[group] = []
                open_rows[group] = 0
                space = chunk
            take = min(size - lo, space)
            open_parts[group].append(Part(i, lo, lo + take))
            open_rows[group] += take
            if take < size - lo or lo > 0:
                split_reqs.add(i)
            lo += take

    for group in order:
        close(group)

    merges = 0
    for c in closed:
        reqs_in_chunk = {p.req for p in c.parts}
        if len(reqs_in_chunk) > 1:
            merges += len(reqs_in_chunk)
    return Plan(tuple(closed), merges=merges, splits=len(split_reqs))


def validate_plan(plan: Plan, requests, chunk: int, tile: int,
                  ndevices: int = 1) -> list[str]:
    """Every violated guarantee as a readable string (empty: the plan is
    sound)."""
    problems: list[str] = []
    seen: dict[int, int] = {}         # req -> next expected spec index
    for ci, c in enumerate(plan.chunks):
        rows = sum(len(p) for p in c.parts)
        if rows != c.rows:
            problems.append(f"chunk {ci}: rows {c.rows} != parts {rows}")
        if c.rows > c.pad:
            problems.append(f"chunk {ci}: rows {c.rows} > pad {c.pad}")
        if c.pad > chunk:
            problems.append(f"chunk {ci}: pad {c.pad} exceeds compiled "
                            f"chunk {chunk}")
        if c.pad != ladder_pad(c.rows, chunk, tile, ndevices):
            problems.append(f"chunk {ci}: pad {c.pad} off the bucket "
                            f"ladder")
        for p in c.parts:
            group, size = requests[p.req]
            if group != c.group:
                problems.append(f"chunk {ci}: request {p.req} of group "
                                f"{group!r} in chunk of {c.group!r}")
            want = seen.get(p.req, 0)
            if p.lo != want:
                problems.append(f"request {p.req}: part starts at "
                                f"{p.lo}, expected {want} (reorder/gap)")
            if not (0 <= p.lo < p.hi <= size):
                problems.append(f"request {p.req}: part [{p.lo},{p.hi}) "
                                f"outside size {size}")
            seen[p.req] = p.hi
    for i, (_, size) in enumerate(requests):
        if seen.get(i, 0) != size:
            problems.append(f"request {i}: covered {seen.get(i, 0)} of "
                            f"{size} specs")
    return problems


class ArrivalEstimator:
    """Adaptive linger from the observed request arrival rate.

    Keeps an EWMA of submit inter-arrival times; the drain lingers
    ``gain x`` that estimate (time for ~``gain`` more peers to arrive),
    clamped to ``[0, max_s]``.  Pure host arithmetic, fed monotonic
    timestamps, so the policy is testable without a clock."""

    def __init__(self, alpha: float = 0.2, gain: float = 2.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.gain = gain
        self._last_t: float | None = None
        self._dt: float | None = None   # EWMA inter-arrival seconds

    def observe(self, t: float) -> None:
        """Record one arrival at monotonic time ``t``."""
        if self._last_t is not None:
            dt = max(t - self._last_t, 0.0)
            self._dt = dt if self._dt is None \
                else (1.0 - self.alpha) * self._dt + self.alpha * dt
        self._last_t = t

    @property
    def interarrival_s(self) -> float | None:
        return self._dt

    def linger(self, max_s: float) -> float:
        """The linger window for the next drain: ``gain x`` the EWMA
        inter-arrival, clamped to ``[0, max_s]`` (``max_s`` before any
        estimate exists: a cold queue waits the full window once)."""
        if max_s <= 0.0:
            return 0.0
        if self._dt is None:
            return max_s
        return min(max(self.gain * self._dt, 0.0), max_s)
