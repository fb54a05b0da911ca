"""The front door of the port: a :class:`Session` owns the memoized tables
and the evaluation knobs, and scores designs on one device.

The PyTorch port of the JAX package's ``core/session.py``, without the
submit queue, the mesh and the multi-model and schedule entry points:
``evaluate`` on one spec or notation string (the scalar Builder, plain
Python on the host, whatever the session's device), on a list of them and
on a ``DesignBatch`` (the batch path, on the session's device); ``build``
and ``explain`` on one design; ``explore``, the DSE (random sweep or
guided search) on the session's device; and ``compile_stats``,
``cache_stats`` and ``observability``.  The device is explicit: ``cuda``
unless the caller passes ``device="cpu"``, and a Session asked for
``cuda`` on a machine without a visible card raises instead of running on
the CPU.  A faulted kernel is retried (``EvalConfig.max_retries``) and
then raises ``EvalError(BACKEND_FAULT)``: nothing falls back to the plain
version.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..kernels import launches
from ..kernels._nvcc import builds
from ..telemetry.report import bottleneck_report
from . import telemetry
from .batch_eval import (DEFAULT_CHUNK, DEFAULT_TILE, DeviceTables,
                         NetTables, _evaluate_specs, bucket_max_L,
                         evaluate_batch, make_device_tables, make_tables)
from .cache import DEFAULT_MAX_TABLES, TABLES_ENV, BoundedLRU, env_bound
from .device import DeviceSpec
from .dse.driver import DEFAULT_OBJECTIVES, DSEResult, _explore
from .dse.encoding import NC, DesignBatch, validate_batch
from .evaluator import _evaluate_design, build_design
from .notation import AcceleratorSpec, parse
from .resilience import (CircuitBreaker, EvalError, classify,
                         nonfinite_keys, retry_delay, wrap)
from .workload import Network


@contextlib.contextmanager
def _taxonomy():
    """The error boundary of an evaluation path: an :class:`EvalError`
    passes as it is, anything else leaves as ``wrap(e)`` caused by ``e``."""
    try:
        yield
    except EvalError:
        raise
    except Exception as e:  # noqa: BLE001 — taxonomy boundary
        raise wrap(e) from e


@dataclass(frozen=True)
class EvalConfig:
    """Every evaluation knob in one place, resolved at session creation."""

    #: torch device the session evaluates on ("cuda", "cuda:1", "cpu")
    device: str = "cuda"
    #: designs per block on the CPU (the plain search's memory bound)
    tile: int = DEFAULT_TILE
    #: feature-map tile rows of Eq. 4's double buffers
    fm_tile_rows: int = 2
    #: designs per chunk: spec lists are encoded and padded per chunk, and
    #: on the card each chunk is one search-kernel launch
    chunk: int = DEFAULT_CHUNK
    #: bound of each memoized table cache, in entries.  None resolves
    #: REPRO_CACHE_TABLES (default 256); 0 disables eviction
    max_cached_tables: int | None = None
    #: retries of a faulted batch-path call, with exponential backoff
    #: (``resilience.retry_delay``) between attempts; past them the call
    #: raises ``EvalError(BACKEND_FAULT)``
    max_retries: int = 0

    def resolved(self) -> "EvalConfig":
        """Check the knobs and pin the env-dependent cache bound."""
        for name in ("tile", "fm_tile_rows", "chunk"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        return replace(
            self, max_cached_tables=env_bound(TABLES_ENV, DEFAULT_MAX_TABLES)
            if self.max_cached_tables is None else self.max_cached_tables)


@dataclass
class SessionStats:
    """Host-side counters of what a session reused vs rebuilt.

    Every mutation goes through :meth:`bump`, under the stats lock: plain
    ``+=`` on the fields from several threads is a lost-update race.
    """

    net_table_builds: int = 0
    net_table_hits: int = 0
    device_table_builds: int = 0
    device_table_hits: int = 0
    net_table_evictions: int = 0
    device_table_evictions: int = 0
    batch_designs: int = 0
    scalar_evals: int = 0
    explore_calls: int = 0
    retried: int = 0           # retry attempts of a faulted call
    degraded: int = 0          # calls served by a fallback: always 0, the
                               # port has none (kept for the JAX schema)

    def __post_init__(self):
        # not a dataclass field: stays out of fields()/as_dict()/repr
        self._lock = threading.Lock()

    def bump(self, name: str, n: int = 1) -> None:
        """Atomically increment counter ``name`` (and mirror it into the
        telemetry registry when enabled)."""
        with self._lock:
            setattr(self, name, getattr(self, name) + n)
        telemetry.count(f"session.{name}", n)

    def as_dict(self) -> dict[str, int]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class Session:
    """One front door for MCCM evaluation on one device.

    >>> ses = Session(get_board("zc706"))                 # on the card
    >>> ses.evaluate(spec, net)                           # Metrics
    >>> ses.evaluate([spec_a, spec_b], net)               # metric arrays
    >>> ses.evaluate(design_batch, net)                   # metric tensors
    """

    def __init__(self, dev: DeviceSpec | None = None, *,
                 config: EvalConfig | None = None, **overrides):
        base = config if config is not None else EvalConfig()
        if overrides:
            base = replace(base, **overrides)
        self.config = base.resolved()
        self.device = torch.device(self.config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Session(device={self.config.device!r}) needs a visible "
                f"CUDA card and none is available; pass device='cpu' to "
                f"run the plain PyTorch path on the CPU")
        self.default_device = dev
        self.stats = SessionStats()
        #: counts consecutive backend faults and trips open past its
        #: threshold; with no fallback it records and reports only
        self.breaker = CircuitBreaker()
        # the table lock is held across check+build+insert
        self._table_lock = threading.Lock()
        bound = self.config.max_cached_tables
        self._net_tables = BoundedLRU(
            bound, on_evict=lambda *_: self.stats.bump("net_table_evictions"))
        self._dev_tables = BoundedLRU(
            bound,
            on_evict=lambda *_: self.stats.bump("device_table_evictions"))

    # ---- memoized tables -------------------------------------------------
    @staticmethod
    def _net_key(net: Network) -> tuple:
        # content fingerprint, not identity: two builds of the same zoo
        # entry share tables, same-named custom nets don't collide, and
        # permuted nets don't alias (layer order matters to segmentation)
        layers = hash(tuple((l.macs, l.weights_size, l.ifm_size,
                             l.ofm_size, l.residual) for l in net))
        return (net.name, len(net), net.total_macs, layers)

    def _device(self, dev: DeviceSpec | None) -> DeviceSpec:
        dev = dev if dev is not None else self.default_device
        if dev is None:
            raise ValueError("no device: pass dev= or construct the "
                             "Session with a default board")
        return dev

    def tables(self, net: Network, max_L: int | None = None) -> NetTables:
        """Memoized ``NetTables`` for ``net`` on the session's device,
        keyed by (net, bucketed max_L)."""
        if isinstance(net, NetTables):
            return net
        L = len(net)
        bucket = bucket_max_L(L) if max_L is None \
            else (max_L if L <= max_L else bucket_max_L(L, base=max_L))
        key = self._net_key(net) + (bucket,)
        with self._table_lock:
            hit = self._net_tables.get(key)
            if hit is not None:
                self.stats.bump("net_table_hits")
                return hit
            with telemetry.span("session.net_table_build") as sp:
                sp.set_attr("net", net.name)
                sp.set_attr("max_L", bucket)
                built = make_tables(net, max_L=bucket, device=self.device)
            self._net_tables.put(key, built)
            self.stats.bump("net_table_builds")
            return built

    def device_tables(self, dev: DeviceSpec | None = None) -> DeviceTables:
        """Memoized ``DeviceTables`` for a board on the session's device."""
        dev = self._device(dev)
        with self._table_lock:
            hit = self._dev_tables.get(dev)
            if hit is not None:
                self.stats.bump("device_table_hits")
                return hit
            with telemetry.span("session.device_table_build"):
                built = make_device_tables(dev, device=self.device)
            self._dev_tables.put(dev, built)
            self.stats.bump("device_table_builds")
            return built

    # ---- resilience ------------------------------------------------------
    def _resilient_call(self, call):
        """Run ``call()`` under the session's fault policy, the JAX
        package's with no fallback backend:

        * input-shaped errors raise ``EvalError(INVALID_INPUT)`` at once
          (an ``EvalError`` raised inside passes as it is) -- retrying
          can't help;
        * a backend fault (a kernel build or launch) is retried up to
          ``max_retries`` times with exponential backoff, each fault fed
          to the circuit breaker and each success closing it;
        * past the retries the call raises ``EvalError(BACKEND_FAULT)``
          caused by the last fault.  There is no fallback: a call on a
          CUDA tensor never runs the plain version.
        """
        last = None
        for attempt in range(self.config.max_retries + 1):
            if attempt:
                self.stats.bump("retried")
                telemetry.event("resilience.retry", {"attempt": attempt})
                time.sleep(retry_delay(attempt))
            try:
                out = call()
            except Exception as e:  # noqa: BLE001 — classified below
                if classify(e) != EvalError.BACKEND_FAULT:
                    if isinstance(e, EvalError):
                        raise
                    raise wrap(e) from e
                self.breaker.record_failure()
                last = e
            else:
                self.breaker.record_success()
                return out
        if isinstance(last, EvalError):
            raise last
        raise wrap(last, EvalError.BACKEND_FAULT) from last

    # ---- evaluation ------------------------------------------------------
    def evaluate(self, designs, net: Network, dev: DeviceSpec | None = None,
                 *, inter_segment_pipelining: bool = True):
        """Evaluate design(s) of ``net`` on ``dev``, dispatching on input:

        * a single spec or notation string -> the scalar Builder, returning
          a full :class:`~repro_torch.core.accelerator.Metrics` (with
          per-segment, per-layer and per-CE detail).  It runs on the host
          in plain Python, on a ``cuda`` session too;
        * a list/tuple of specs or notation strings -> the chunked batch
          path, returning ``{metric: np.ndarray}``;
        * a ``DesignBatch`` -> the batch path verbatim, returning
          ``{metric: torch.Tensor}`` on the session's device.

        ``inter_segment_pipelining`` applies to notation strings only.
        Every path raises :class:`EvalError`: an input error as
        ``INVALID_INPUT``, anything else (a failed kernel launch on the
        card included) as ``BACKEND_FAULT``.  The list and ``DesignBatch``
        paths retry a fault ``max_retries`` times first
        (:meth:`_resilient_call`); nothing falls back to the plain version.
        """
        with telemetry.span("session.evaluate") as sp:
            return self._evaluate(designs, net, dev,
                                  inter_segment_pipelining, sp)

    def _evaluate(self, designs, net, dev, inter_segment_pipelining, sp):
        dev = self._device(dev)
        if isinstance(designs, (str, AcceleratorSpec)):
            sp.set_attr("kind", "scalar")
            self.stats.bump("scalar_evals")
            with _taxonomy():
                m = _evaluate_design(
                    designs, net, dev,
                    inter_segment_pipelining=inter_segment_pipelining)
            if not np.isfinite([m.latency_s, m.throughput_ips,
                                float(m.buffer_bytes)]).all():
                raise EvalError(EvalError.NONFINITE_METRICS,
                                "scalar evaluation produced non-finite "
                                "metrics")
            return m
        cfg = self.config
        if isinstance(designs, DesignBatch):
            try:
                ok = validate_batch(designs, len(net), min_ces=1, max_ces=NC)
            except (ValueError, TypeError, IndexError) as e:
                raise EvalError(EvalError.INVALID_INPUT,
                                f"{type(e).__name__}: {e}") from e
            if not ok.all():
                bad = np.nonzero(~ok)[0]
                raise EvalError(
                    EvalError.INVALID_INPUT,
                    f"{bad.size} invalid DesignBatch row(s), first at "
                    f"index {int(bad[0])} (non-canonical segments or CE "
                    f"count outside [1, {NC}])")
            sp.set_attr("kind", "design_batch")
            sp.set_attr("designs", designs.batch)
            self.stats.bump("batch_designs", designs.batch)
            return self._resilient_call(lambda: evaluate_batch(
                designs.to(self.device), self.tables(net),
                self.device_tables(dev), cfg.fm_tile_rows, tile=cfg.tile,
                chunk=cfg.chunk))
        try:
            specs = [parse(d, len(net), inter_segment_pipelining=
                           inter_segment_pipelining)
                     if isinstance(d, str) else d for d in designs]
        except (ValueError, TypeError) as e:
            raise EvalError(EvalError.INVALID_INPUT,
                            f"{type(e).__name__}: {e}") from e
        if not specs:
            raise EvalError(EvalError.INVALID_INPUT,
                            "no designs to evaluate (empty list)")
        sp.set_attr("kind", "spec_list")
        sp.set_attr("designs", len(specs))
        self.stats.bump("batch_designs", len(specs))
        out = self._resilient_call(lambda: _evaluate_specs(
            specs, net, self.device_tables(dev), cfg.chunk,
            tables=self.tables(net), tile=cfg.tile,
            fm_tile_rows=cfg.fm_tile_rows))
        bad = nonfinite_keys(out)
        if bad:
            raise EvalError(EvalError.NONFINITE_METRICS,
                            f"non-finite metrics {bad}")
        return out

    def build(self, design, net: Network, dev: DeviceSpec | None = None,
              *, opts=None, inter_segment_pipelining: bool = True):
        """Build the :class:`ConcreteAccelerator` for a design (the object
        ``evaluate`` scores — same parse flags, so they always agree)."""
        return build_design(design, net, self._device(dev), opts,
                            inter_segment_pipelining=inter_segment_pipelining)

    # ---- bottleneck attribution (paper use case 2) -----------------------
    def explain(self, design, net: Network, dev: DeviceSpec | None = None,
                *, inter_segment_pipelining: bool = True,
                refine: str | None = None) -> dict:
        """Rank where a single design's time and off-chip traffic go.

        Evaluates ``design`` through the scalar path and returns the
        :func:`repro_torch.telemetry.report.bottleneck_report` dict:
        segments ranked by occupancy with compute/memory bound verdicts,
        the busiest CE, Fig. 6's memory-bound layers and idle fraction, and
        Fig. 7's weights-vs-FMs access split.

        ``refine="schedule"`` (the JAX package's per-CE temporal-mapping
        refinement) raises ``NotImplementedError``: the schedule layer is
        a later slice of the port (``ROADMAP.md``, queue 1).
        """
        if not isinstance(design, (str, AcceleratorSpec)):
            raise EvalError(
                EvalError.INVALID_INPUT,
                "explain() takes one design (notation string or "
                "AcceleratorSpec); use evaluate() for batches")
        if refine not in (None, "schedule"):
            raise EvalError(EvalError.INVALID_INPUT,
                            f"unknown refine mode {refine!r} "
                            "(expected None or 'schedule')")
        if refine == "schedule":
            raise NotImplementedError(
                "explain(refine='schedule') needs the schedule layer, which "
                "the port does not have yet (ROADMAP.md, queue 1: the "
                "schedule slice)")
        return bottleneck_report(self.evaluate(
            design, net, dev,
            inter_segment_pipelining=inter_segment_pipelining))

    # ---- DSE (paper use case 3) ------------------------------------------
    def explore(self, net: Network, n: int = 100_000,
                dev: DeviceSpec | None = None, *, strategy: str = "random",
                family: str = "custom", seed: int = 0, chunk: int = 4096,
                objectives: tuple[str, ...] = DEFAULT_OBJECTIVES,
                config=None, refine: str | None = None) -> DSEResult:
        """Single-model DSE on the session's device: a random sweep of ``n``
        designs of ``family``, drawn ``chunk`` at a time, or the guided
        search (``strategy="search"``, a ``SearchConfig`` in ``config``) at
        the same budget.  Returns a :class:`DSEResult`: every evaluated
        design, its metrics and the Pareto front of ``objectives``.  The
        same seed draws the same designs as the JAX package's
        ``Session.explore``.

        ``refine="schedule"`` (the JAX package's schedule-refined front)
        raises ``NotImplementedError``: the schedule layer is a later slice
        of the port (``ROADMAP.md``, queue 1).  A kernel fault raises
        ``EvalError(BACKEND_FAULT)`` and is fed to the breaker; a search is
        not retried, and nothing falls back to the plain version.
        """
        if refine not in (None, "schedule"):
            raise EvalError(EvalError.INVALID_INPUT,
                            f"unknown refine mode {refine!r} "
                            "(expected None or 'schedule')")
        if refine == "schedule":
            raise NotImplementedError(
                "explore(refine='schedule') needs the schedule layer, which "
                "the port does not have yet (ROADMAP.md, queue 1: the "
                "schedule slice)")
        self.stats.bump("explore_calls")
        cfg = self.config
        with telemetry.span("session.explore") as sp:
            sp.set_attr("n", n)
            sp.set_attr("strategy", strategy)
            try:
                return _explore(net, self._device(dev), n, family=family,
                                seed=seed, chunk=chunk, strategy=strategy,
                                objectives=objectives, config=config,
                                tables=self.tables(net), tile=cfg.tile,
                                eval_chunk=cfg.chunk)
            except Exception as e:  # noqa: BLE001 — classified below
                if classify(e) != EvalError.BACKEND_FAULT \
                        or isinstance(e, (EvalError, NotImplementedError)):
                    raise
                self.breaker.record_failure()
                raise wrap(e, EvalError.BACKEND_FAULT) from e

    # ---- observability ---------------------------------------------------
    def compile_stats(self) -> dict[str, int]:
        """What the port builds instead of jit programs: the kernel
        libraries built with ``nvcc`` (``kernel_builds``) and loaded
        (``kernel_loads``) in this process, the kernel launches since the
        last ``repro_torch.kernels.reset_launches()`` (``launches.<name>``)
        and the resilience counters.  ``total`` is builds plus loads, the
        counter cache-reuse checks assert on: a warm round adds zero."""
        b = builds()
        counts = {"kernel_builds": b["built"], "kernel_loads": b["loaded"]}
        counts["total"] = counts["kernel_builds"] + counts["kernel_loads"]
        counts.update({f"launches.{k}": v for k, v in launches().items()})
        counts["retried"] = self.stats.retried
        counts["degraded"] = self.stats.degraded
        return counts

    def cache_stats(self) -> dict[str, dict[str, int]]:
        """Size / bound / eviction counters of the two table memos."""
        with self._table_lock:
            return {"net_tables": self._net_tables.stats(),
                    "device_tables": self._dev_tables.stats()}

    def observability(self) -> dict:
        """One-stop report: build and launch counts, session counters,
        cache occupancy/evictions, breaker state and the telemetry
        registry snapshot (counters/gauges/histograms; empty while
        telemetry is disabled)."""
        return {
            "compile": self.compile_stats(),
            "stats": self.stats.as_dict(),
            "caches": self.cache_stats(),
            "breaker": {"open": self.breaker.is_open,
                        "trips": self.breaker.trips},
            "telemetry": telemetry.snapshot(),
        }
