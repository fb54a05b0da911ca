"""Spans, a metrics registry and exporters: the port's observability core.

A copy of the JAX package's ``core/telemetry.py`` with the same names, env
variables and trace-line schema, so one dashboard or trace reader serves
both packages.  Three pieces, stdlib-only:

* **spans** -- :func:`span` is a context manager recording monotonic
  wall time, nesting (thread-local stack -> parent/trace ids) and
  per-span attributes; :func:`event` attaches point-in-time events
  (retries, breaker transitions, checkpoint writes, search generations)
  to the current span;
* **metrics registry** -- process-wide counters, gauges and fixed-bucket
  histograms (:func:`count` / :func:`gauge` / :func:`observe`).  The
  bucket ladder makes p50/p99/p999 derivable without storing samples;
* **exporters** -- a JSONL trace file (one event per line, gated by
  ``REPRO_TELEMETRY_DIR``), a Prometheus-style text :func:`prometheus_text`
  snapshot, and the in-process :func:`snapshot` dict that
  ``Session.observability()`` merges into its reporting.

Telemetry is **off by default and cheap when off**: every entry point
checks one module-level flag and returns a shared singleton, so the
disabled path allocates nothing.  Enable it with the env var::

    REPRO_TELEMETRY_DIR=/tmp/traces python ...   # metrics + JSONL trace

or programmatically with :func:`enable` (no directory = in-process
metrics only).  :func:`profile` is the opt-in deep dive: a
``torch.profiler`` Chrome trace of a block.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

__all__ = [
    "TELEMETRY_DIR_ENV", "enable", "disable", "enabled", "reset",
    "span", "event", "count", "gauge", "observe",
    "snapshot", "prometheus_text", "trace_path",
    "validate_trace_line", "read_trace", "profile",
    "Histogram", "DEFAULT_BUCKETS",
]

#: trace-export directory; setting it (before import or via
#: :func:`enable`) turns telemetry on with a JSONL sink
TELEMETRY_DIR_ENV = "REPRO_TELEMETRY_DIR"
#: opt-in ``torch.profiler`` deep-dive directory (see :func:`profile`)
PROFILE_ENV = "REPRO_TELEMETRY_PROFILE"

#: the one flag every instrumentation site checks first.  Plain module
#: global (not behind a lock): reads are atomic in CPython and the
#: disabled path must stay branch-cheap.
_ENABLED = False


# --------------------------------------------------------------------------
# metrics registry: counters, gauges, fixed-bucket histograms
# --------------------------------------------------------------------------
def _log_buckets(lo: float, hi: float, per_decade: int) -> tuple:
    """Log-spaced bucket upper bounds covering [lo, hi]."""
    import math
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))

#: default histogram ladder: 1 µs .. 1000 s, 4 buckets per decade —
#: wide enough for queue waits and whole-search spans, fine enough that
#: adjacent bounds differ by ~78% (p50/p99 resolution for latencies)
DEFAULT_BUCKETS = _log_buckets(1e-6, 1e3, 4)


class Histogram:
    """Fixed-bucket histogram: percentiles without storing samples.

    ``bounds`` are ascending bucket *upper* bounds; an implicit +inf
    bucket catches the overflow.  :meth:`percentile` returns the upper
    bound of the bucket holding the q-th observation (Prometheus
    ``histogram_quantile`` semantics without interpolation), so feeding
    values that sit exactly on bucket bounds makes percentiles exact —
    the property the unit tests pin.
    """

    __slots__ = ("bounds", "counts", "total", "sum")

    def __init__(self, bounds=DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly ascending")
        self.counts = [0] * (len(self.bounds) + 1)   # +1: the +inf bucket
        self.total = 0
        self.sum = 0.0

    def _bucket_of(self, value: float) -> int:
        # binary search over <= 50 bounds; bisect keeps it allocation-free
        import bisect
        return bisect.bisect_left(self.bounds, value)

    def observe(self, value: float) -> None:
        self.counts[self._bucket_of(value)] += 1
        self.total += 1
        self.sum += value

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket containing the ``q``-quantile
        observation (``0 < q <= 1``); NaN when empty, +inf when the
        quantile lands in the overflow bucket."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"q must be in (0, 1], got {q}")
        if self.total == 0:
            return float("nan")
        rank = max(1, int(-(-q * self.total // 1)))   # ceil(q * total)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.bounds[i] if i < len(self.bounds) \
                    else float("inf")
        return float("inf")                           # pragma: no cover

    def as_dict(self) -> dict:
        return {
            "count": self.total,
            "sum": self.sum,
            "mean": self.sum / self.total if self.total else float("nan"),
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
            "p999": self.percentile(0.999),
        }


class _Registry:
    """Process-wide metric store.  One lock — every mutation is a dict
    op, contention is negligible next to the evaluations being timed."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}

    def size(self) -> int:
        with self.lock:
            return (len(self.counters) + len(self.gauges)
                    + len(self.histograms))


_REGISTRY = _Registry()


def count(name: str, n: float = 1) -> None:
    """Increment counter ``name`` by ``n`` (no-op while disabled)."""
    if not _ENABLED:
        return
    r = _REGISTRY
    with r.lock:
        r.counters[name] = r.counters.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    """Set gauge ``name`` to ``value`` (no-op while disabled)."""
    if not _ENABLED:
        return
    r = _REGISTRY
    with r.lock:
        r.gauges[name] = float(value)


def observe(name: str, value: float, bounds=DEFAULT_BUCKETS) -> None:
    """Record ``value`` into histogram ``name`` (no-op while disabled);
    ``bounds`` applies only on first touch."""
    if not _ENABLED:
        return
    r = _REGISTRY
    with r.lock:
        h = r.histograms.get(name)
        if h is None:
            h = r.histograms[name] = Histogram(bounds)
        h.observe(float(value))


# --------------------------------------------------------------------------
# spans: nested, monotonic-timed, attributed
# --------------------------------------------------------------------------
_LOCAL = threading.local()
_ID_LOCK = threading.Lock()
_NEXT_ID = [1]


def _new_id() -> int:
    with _ID_LOCK:
        i = _NEXT_ID[0]
        _NEXT_ID[0] += 1
        return i


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _NoopSpan:
    """The shared disabled-path span: every method is a no-op and
    :func:`span` always returns THIS object, so the disabled path
    allocates nothing (identity-tested)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, name, value):
        pass

    def add_event(self, name, **attrs):
        pass


_NOOP = _NoopSpan()


class Span:
    """One timed unit of work.  Use via :func:`span`."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "trace_id",
                 "events", "t_wall", "_t0", "dur_s")

    def __init__(self, name: str, attrs: dict | None):
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.span_id = _new_id()
        self.parent_id = None
        self.trace_id = None
        self.events: list[dict] = []
        self.t_wall = 0.0
        self._t0 = 0.0
        self.dur_s = 0.0

    def set_attr(self, name: str, value) -> None:
        self.attrs[name] = value

    def add_event(self, name: str, **attrs) -> None:
        self.events.append({"name": name,
                            "t": time.perf_counter() - self._t0,
                            "attrs": attrs})

    def __enter__(self) -> "Span":
        st = _stack()
        if st:
            self.parent_id = st[-1].span_id
            self.trace_id = st[-1].trace_id
        else:
            self.trace_id = self.span_id
        st.append(self)
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur_s = time.perf_counter() - self._t0
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:                   # tolerate misnested exits
            st.remove(self)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        if _ENABLED:
            observe(f"span.{self.name}.s", self.dur_s)
            _write({"type": "span", "name": self.name,
                    "trace": self.trace_id, "span": self.span_id,
                    "parent": self.parent_id, "t_wall": self.t_wall,
                    "dur_s": self.dur_s, "attrs": self.attrs,
                    "events": self.events})
        return False


def span(name: str, attrs: dict | None = None):
    """A context manager timing one named unit of work.  Returns the
    shared no-op singleton while telemetry is disabled — zero allocation
    on the disabled path."""
    if not _ENABLED:
        return _NOOP
    return Span(name, attrs)


def current_span():
    """The innermost open span of this thread (the no-op singleton when
    disabled or outside any span)."""
    if not _ENABLED:
        return _NOOP
    st = _stack()
    return st[-1] if st else _NOOP


def event(name: str, attrs: dict | None = None) -> None:
    """Record a point-in-time event: attached to the current span (if
    any), counted (``event.<name>``), and written to the trace sink as
    its own line.  No-op while disabled."""
    if not _ENABLED:
        return
    count(f"event.{name}")
    st = _stack()
    parent = st[-1] if st else None
    if parent is not None:
        parent.add_event(name, **(attrs or {}))
    _write({"type": "event", "name": name,
            "trace": parent.trace_id if parent else None,
            "span": parent.span_id if parent else None,
            "t_wall": time.time(), "attrs": dict(attrs or {})})


# --------------------------------------------------------------------------
# the JSONL trace sink
# --------------------------------------------------------------------------
class _Sink:
    def __init__(self, directory: str):
        self.directory = directory
        self.lock = threading.Lock()
        self._fh = None

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"trace-{os.getpid()}.jsonl")

    def write(self, obj: dict) -> None:
        line = json.dumps(obj, separators=(",", ":"), default=str)
        with self.lock:
            if self._fh is None:
                os.makedirs(self.directory, exist_ok=True)
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self.lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_SINK: _Sink | None = None


def _write(obj: dict) -> None:
    sink = _SINK
    if sink is not None:
        sink.write(obj)


def trace_path() -> str | None:
    """The JSONL file this process is writing, or None (disabled / no
    export directory configured)."""
    return _SINK.path if _SINK is not None else None


#: required keys per trace-line type (the schema CI validates)
_SCHEMA = {
    "span": {"name": str, "trace": int, "span": int,
             "t_wall": float, "dur_s": float, "attrs": dict,
             "events": list},
    "event": {"name": str, "t_wall": float, "attrs": dict},
}


def validate_trace_line(obj) -> list[str]:
    """Schema problems of one decoded trace line ([] = valid)."""
    if not isinstance(obj, dict):
        return ["line is not an object"]
    kind = obj.get("type")
    if kind not in _SCHEMA:
        return [f"unknown type {kind!r}"]
    problems = []
    for key, typ in _SCHEMA[kind].items():
        if key not in obj:
            problems.append(f"{kind}: missing key {key!r}")
        elif typ is float:
            if not isinstance(obj[key], (int, float)):
                problems.append(f"{kind}.{key}: not a number")
        elif not isinstance(obj[key], typ):
            problems.append(f"{kind}.{key}: not a {typ.__name__}")
    if kind == "span" and not problems:
        if obj["dur_s"] < 0:
            problems.append("span.dur_s: negative")
        for ev in obj["events"]:
            if not isinstance(ev, dict) or "name" not in ev:
                problems.append("span.events: malformed entry")
    return problems


def read_trace(path: str) -> list[dict]:
    """Decode + schema-validate a JSONL trace; raises ``ValueError`` on
    the first invalid line."""
    out = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            if not line.strip():
                continue
            obj = json.loads(line)
            problems = validate_trace_line(obj)
            if problems:
                raise ValueError(f"{path}:{i}: {'; '.join(problems)}")
            out.append(obj)
    return out


# --------------------------------------------------------------------------
# snapshots + Prometheus export
# --------------------------------------------------------------------------
def snapshot() -> dict:
    """The in-process metric state: ``{counters, gauges, histograms}``
    (histograms summarized as count/sum/mean/p50/p90/p99/p999)."""
    r = _REGISTRY
    with r.lock:
        return {
            "enabled": _ENABLED,
            "counters": dict(r.counters),
            "gauges": dict(r.gauges),
            "histograms": {k: h.as_dict()
                           for k, h in r.histograms.items()},
        }


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"repro_{out}"


def prometheus_text() -> str:
    """A Prometheus text-exposition snapshot of the registry (counters,
    gauges, and histograms with cumulative ``le`` buckets)."""
    r = _REGISTRY
    lines = []
    with r.lock:
        for name in sorted(r.counters):
            p = _prom_name(name)
            lines += [f"# TYPE {p} counter", f"{p} {r.counters[name]:g}"]
        for name in sorted(r.gauges):
            p = _prom_name(name)
            lines += [f"# TYPE {p} gauge", f"{p} {r.gauges[name]:g}"]
        for name in sorted(r.histograms):
            h = r.histograms[name]
            p = _prom_name(name)
            lines.append(f"# TYPE {p} histogram")
            cum = 0
            for bound, c in zip(h.bounds, h.counts):
                cum += c
                lines.append(f'{p}_bucket{{le="{bound:g}"}} {cum}')
            lines.append(f'{p}_bucket{{le="+Inf"}} {h.total}')
            lines.append(f"{p}_sum {h.sum:g}")
            lines.append(f"{p}_count {h.total}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# lifecycle
# --------------------------------------------------------------------------
def enabled() -> bool:
    return _ENABLED


def enable(directory: str | None = None) -> None:
    """Turn telemetry on.  With ``directory`` (or ``REPRO_TELEMETRY_DIR``
    already set) spans/events also export to a JSONL trace file there;
    without one, only the in-process registry records."""
    global _ENABLED, _SINK
    directory = directory or os.environ.get(TELEMETRY_DIR_ENV) or None
    if directory:
        if _SINK is None or _SINK.directory != directory:
            if _SINK is not None:
                _SINK.close()
            _SINK = _Sink(directory)
    _ENABLED = True


def disable() -> None:
    """Turn telemetry off (the registry keeps its contents; see
    :func:`reset`)."""
    global _ENABLED, _SINK
    _ENABLED = False
    if _SINK is not None:
        _SINK.close()
        _SINK = None


def reset() -> None:
    """Clear every counter/gauge/histogram (test isolation helper)."""
    r = _REGISTRY
    with r.lock:
        r.counters.clear()
        r.gauges.clear()
        r.histograms.clear()


# env-gated activation: REPRO_TELEMETRY_DIR set at import time = on
if os.environ.get(TELEMETRY_DIR_ENV):
    enable(os.environ[TELEMETRY_DIR_ENV])


# --------------------------------------------------------------------------
# opt-in deep dive: torch.profiler
# --------------------------------------------------------------------------
_PROFILE_SEQ = [0]


@contextlib.contextmanager
def profile(directory: str | None = None):
    """Wrap a block in ``torch.profiler.profile`` (CPU, and CUDA where a
    card is visible) when a directory is given or
    ``REPRO_TELEMETRY_PROFILE`` is set, and write its Chrome trace there
    as ``profile-<pid>-<n>.json``; otherwise a no-op."""
    directory = directory or os.environ.get(PROFILE_ENV) or None
    if not directory:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _ID_LOCK:
        _PROFILE_SEQ[0] += 1
        seq = _PROFILE_SEQ[0]
    path = os.path.join(directory, f"profile-{os.getpid()}-{seq}.json")
    with span("telemetry.profile", {"dir": directory}), \
            torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(path)
