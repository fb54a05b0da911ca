"""The front door of the port: a :class:`Session` owns the memoized tables
and the evaluation knobs, and scores designs on its device (or its mesh).

The PyTorch port of the JAX package's ``core/session.py``: ``evaluate``
on one spec or notation string (the scalar Builder, plain Python on the
host, whatever the session's device), on a list of them and on a
``DesignBatch`` (the
batch path, on the session's device); ``build`` and ``explain`` on one
design; ``schedule``, the per-CE temporal-mapping search under one design
(and ``refine="schedule"`` on ``explain`` and ``explore``), on the
session's device; ``explore``, the DSE (random sweep or guided search) on
the session's device; ``deploy``, the multi-CNN co-scheduling DSE
(``core.multinet``: spatial, temporal and hybrid arms) on the session's
device; the serving lane: ``submit`` (a
``Future``, served by a background drain that coalesces queued requests
into megabatches, with deadlines and admission control) and
``submit_search`` (long ``explore`` and ``deploy`` jobs on their own
worker); the lifecycle
(``close``, ``with Session(...)``, :func:`default_session`); and
``compile_stats``, ``cache_stats`` and ``observability``.  The batch
paths shard the design axis over the session's ``EvalMesh``
(``EvalConfig.mesh``, ``core.shard``): every card, or shards of the host
under ``REPRO_MESH_DEVICES``; a one-device mesh is the single-device path
unchanged.  The device is
explicit: ``cuda`` unless the caller passes ``device="cpu"``, and a
Session asked for ``cuda`` on a machine without a visible card raises
instead of running on the CPU.  A faulted kernel is retried
(``EvalConfig.max_retries``) and then raises ``EvalError(BACKEND_FAULT)``:
nothing falls back to the plain version, in the drain neither.
"""
from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..kernels import launches
from ..kernels._nvcc import builds
from ..kernels.schedule_score import NCAND
from ..schedule import ScheduleArtifact, build_artifact
from ..schedule.search import schedule_batch, schedule_specs
from ..telemetry.report import bottleneck_report
from . import telemetry
from .batch_eval import (DEFAULT_CHUNK, DEFAULT_TILE, DeviceTables,
                         NetTables, _bucket, _evaluate_specs, _pad_rows,
                         bucket_max_L, evaluate_batch, make_device_tables,
                         make_tables)
from .cache import DEFAULT_MAX_TABLES, TABLES_ENV, BoundedLRU, env_bound
from .coalesce import ArrivalEstimator, plan_megabatch
from .device import DeviceSpec
from .dse.driver import DEFAULT_OBJECTIVES, DSEResult, _explore
from .dse.encoding import NC, DesignBatch, encode_specs, validate_batch
from .dse.search import SearchConfig
from .evaluator import _evaluate_design, build_design
from .multinet.driver import JointDSEResult, _joint_explore
from .multinet.joint_eval import MultiNetTables, make_multi_tables
from .multinet.partition import DEFAULT_MAX_M
from .multinet.search import JOINT_OBJECTIVES, MultinetSearchConfig
from .notation import AcceleratorSpec, format_spec, parse
from .resilience import (CircuitBreaker, EvalError, classify,
                         nonfinite_keys, retry_delay, wrap)
from .shard import EvalMesh, env_mesh_devices
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
    #: model-axis padding of deploy()'s MultiNetTables; None = the
    #: multinet default (DEFAULT_MAX_M)
    max_m: int | None = None
    #: bound of each memoized table cache, in entries.  None resolves
    #: REPRO_CACHE_TABLES (default 256); 0 disables eviction
    max_cached_tables: int | None = None
    #: retries of a faulted batch-path call, with exponential backoff
    #: (``resilience.retry_delay``) between attempts; past them the call
    #: raises ``EvalError(BACKEND_FAULT)``
    max_retries: int = 0
    #: submit() megabatching window: how long the drain lingers after the
    #: first queued request before evaluating, so concurrent callers land
    #: in one megabatch
    linger_s: float = 0.002
    #: adaptive linger cap, in seconds.  None keeps the fixed ``linger_s``
    #: window; a value arms the arrival-rate policy (the drain lingers ~2
    #: observed inter-arrivals, never more than this cap)
    linger_max_s: float | None = None
    #: default per-request deadline of submit(), in seconds: a request not
    #: delivered by then fails with ``EvalError.DEADLINE_EXCEEDED``; None
    #: disables.  submit(deadline_s=...) wins per request
    deadline_s: float | None = None
    #: admission control: most queued submit() requests and search jobs.
    #: Further submits fail at once with ``EvalError.QUEUE_FULL``; None =
    #: unbounded
    max_queue: int | None = None
    #: design-axis mesh width (devices).  None resolves REPRO_MESH_DEVICES,
    #: else every visible device of the session's kind; 1 pins the
    #: single-device path.  The session builds one ``core.shard.EvalMesh``
    #: from this and threads it through evaluate()/explore()/deploy()/
    #: submit()
    mesh: int | None = None

    def resolved(self) -> "EvalConfig":
        """Check the knobs and pin the env-dependent fields (the cache
        bound and the mesh width)."""
        for name in ("tile", "fm_tile_rows", "chunk"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if self.linger_max_s is not None and self.linger_max_s < 0:
            raise ValueError(f"linger_max_s must be >= 0, "
                             f"got {self.linger_max_s}")
        if self.mesh is not None and self.mesh < 1:
            raise ValueError(f"mesh must be >= 1, got {self.mesh}")
        return replace(
            self, max_cached_tables=env_bound(TABLES_ENV, DEFAULT_MAX_TABLES)
            if self.max_cached_tables is None else self.max_cached_tables,
            mesh=self.mesh if self.mesh is not None else env_mesh_devices())


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
    multi_table_builds: int = 0
    multi_table_hits: int = 0
    multi_table_evictions: int = 0
    batch_designs: int = 0
    scalar_evals: int = 0
    explore_calls: int = 0
    deploy_calls: int = 0
    schedule_calls: int = 0
    schedule_builds: int = 0   # schedule searches actually run
    schedule_hits: int = 0     # artifacts served from the bounded memo
    schedule_evictions: int = 0
    submits: int = 0
    megabatches: int = 0
    megabatch_requests: int = 0
    coalesced_chunks: int = 0  # padded chunks planned
    coalesced_merges: int = 0  # requests that shared a chunk with another
    coalesced_splits: int = 0  # requests split at the chunk size
    search_jobs: int = 0       # submit_search() jobs accepted
    rejected: int = 0          # submits refused by admission control
    retried: int = 0           # retry attempts of a faulted call
    degraded: int = 0          # calls served by a fallback: always 0, the
                               # port has none (kept for the JAX schema)
    deadline_missed: int = 0   # requests failed with DEADLINE_EXCEEDED

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


#: submit() priority lanes, highest first: the drain serves interactive
#: requests ahead of batch ones in every megabatch, and search jobs run on
#: their own worker thread
PRIORITIES = ("interactive", "batch")


class _Request:
    """One queued :meth:`Session.submit` unit of work."""

    __slots__ = ("specs", "net", "dev", "future", "scalar", "deadline",
                 "t_enq", "priority")

    def __init__(self, specs, net, dev, future, scalar, deadline=None,
                 priority="interactive"):
        self.specs = specs
        self.net = net
        self.dev = dev
        self.future = future
        self.scalar = scalar
        self.deadline = deadline   # absolute time.monotonic(), or None
        self.priority = priority
        self.t_enq = time.monotonic()   # queue-wait telemetry anchor


class _SearchJob:
    """One queued :meth:`Session.submit_search` job (the batch lane)."""

    __slots__ = ("fn", "future", "deadline", "label", "t_enq")

    def __init__(self, fn, future, deadline=None, label="search"):
        self.fn = fn
        self.future = future
        self.deadline = deadline
        self.label = label
        self.t_enq = time.monotonic()


class Session:
    """One front door for MCCM evaluation on one device.

    >>> ses = Session(get_board("zc706"))                 # on the card
    >>> ses.evaluate(spec, net)                           # Metrics
    >>> ses.evaluate([spec_a, spec_b], net)               # metric arrays
    >>> ses.evaluate(design_batch, net)                   # metric tensors
    >>> ses.submit(specs, net).result()                   # queued, megabatched
    >>> ses.schedule(spec, net)                           # ScheduleArtifact
    >>> ses.deploy([net_a, net_b], n=4096)                # multinet front
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
        #: the session's design-axis mesh, its first device the session's
        #: own (outputs gather there); a single-device mesh leaves every
        #: path on ``self.device``
        self.mesh = EvalMesh(ndevices=self.config.mesh, device=self.device)
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
        self._multi_tables = BoundedLRU(
            bound,
            on_evict=lambda *_: self.stats.bump("multi_table_evictions"))
        # schedule artifacts per (net, board, design): small decoded
        # dataclasses, but keys churn with every distinct design, so the
        # same bound and the same eviction-counter contract
        self._schedule_memo = BoundedLRU(
            bound, on_evict=lambda *_: self.stats.bump("schedule_evictions"))
        # the submit queue and its drain thread (the interactive lane)
        self._cv = threading.Condition()
        self._pending: list[_Request] = []
        self._worker: threading.Thread | None = None
        #: adaptive-linger arrival tracking (armed by config.linger_max_s)
        self._arrivals = ArrivalEstimator()
        # the batch lane: long searches run on their own worker, so the
        # drain never waits behind a 100k-design DSE
        self._jobs: list[_SearchJob] = []
        self._job_cv = threading.Condition()
        self._job_worker: threading.Thread | None = None
        self._job_running = False
        self._closed = False

    # ---- lifecycle -------------------------------------------------------
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Flush the submit queue and stop the drain thread and the
        search-job worker.  Queued search jobs not yet started are
        cancelled; a running job finishes (its checkpoint, when set, is
        what makes killing the process instead lossless).  Idempotent; the
        caches stay usable, only :meth:`submit` and :meth:`submit_search`
        are refused afterwards."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        with self._job_cv:
            cancelled, self._jobs = self._jobs, []
            self._job_cv.notify_all()
        for j in cancelled:
            j.future.cancel()
        if self._worker is not None:
            self._worker.join(timeout=60.0)
            self._worker = None
        if self._job_worker is not None:
            self._job_worker.join(timeout=600.0)
            self._job_worker = None
        self.drain()

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

    def multi_tables(self, nets, *, weights=None, slo_s=None,
                     max_m: int | None = None) -> MultiNetTables:
        """Memoized ``MultiNetTables`` for a model set (+ request weights
        and per-model SLOs) on the session's device: what :meth:`deploy`
        evaluates against.  An explicit ``max_m`` wins over the config
        (deploy passes the search config's)."""
        if max_m is None:
            max_m = self.config.max_m or DEFAULT_MAX_M
        wkey = None if weights is None else tuple(
            float(w) for w in np.atleast_1d(np.asarray(weights, np.float64)))
        skey = None if slo_s is None else tuple(
            float(s) for s in np.atleast_1d(np.asarray(slo_s, np.float64)))
        key = (tuple(self._net_key(n) for n in nets), wkey, skey, max_m)
        with self._table_lock:
            hit = self._multi_tables.get(key)
            if hit is not None:
                self.stats.bump("multi_table_hits")
                return hit
            with telemetry.span("session.multi_table_build") as sp:
                sp.set_attr("models", len(list(nets)))
                built = make_multi_tables(list(nets), weights=weights,
                                          slo_s=slo_s, max_m=max_m,
                                          device=self.device)
            self._multi_tables.put(key, built)
            self.stats.bump("multi_table_builds")
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
            with telemetry.span("session.validate"):
                try:
                    ok = validate_batch(designs, len(net), min_ces=1,
                                        max_ces=NC)
                except (ValueError, TypeError, IndexError) as e:
                    raise EvalError(EvalError.INVALID_INPUT,
                                    f"{type(e).__name__}: {e}") from e
                if not ok.all():
                    bad = np.nonzero(~ok)[0]
                    raise EvalError(
                        EvalError.INVALID_INPUT,
                        f"{bad.size} invalid DesignBatch row(s), first at "
                        f"index {int(bad[0])} (non-canonical segments or "
                        f"CE count outside [1, {NC}])")
            sp.set_attr("kind", "design_batch")
            sp.set_attr("designs", designs.batch)
            self.stats.bump("batch_designs", designs.batch)

            def call():
                with telemetry.span("session.to_device"):
                    on_device = designs.to(self.device)
                return evaluate_batch(
                    on_device, self.tables(net), self.device_tables(dev),
                    cfg.fm_tile_rows, tile=cfg.tile, chunk=cfg.chunk,
                    mesh=self.mesh)
            return self._resilient_call(call)
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
            fm_tile_rows=cfg.fm_tile_rows, mesh=self.mesh))
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

        ``refine="schedule"`` also runs the per-CE temporal-mapping search
        (:meth:`schedule`) and attaches its refined per-segment costs as a
        ``"schedule"`` section: coarse vs refined cycles per segment and
        the headline latency saving.  The coarse attribution is the same
        either way.
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
        m = self.evaluate(design, net, dev,
                          inter_segment_pipelining=inter_segment_pipelining)
        art = None
        if refine == "schedule":
            art = self.schedule(
                design, net, dev,
                inter_segment_pipelining=inter_segment_pipelining)
        return bottleneck_report(m, schedule=art)

    def schedule(self, design, net: Network, dev: DeviceSpec | None = None,
                 *, inter_segment_pipelining: bool = True
                 ) -> ScheduleArtifact:
        """Per-CE temporal-mapping search under one design, on the
        session's device: refine the coarse MCCM estimate by choosing each
        layer's loop order, tile size and buffering from an explicit
        candidate plane, scored in the same cost terms.

        Returns the JSON-serializable
        :class:`~repro_torch.schedule.ScheduleArtifact`: refined vs coarse
        latency/traffic/energy, per-layer chosen mappings, per-CE buffer
        plans and per-segment costs.  Refined latency never exceeds the
        coarse estimate (candidate 0 is the coarse mapping).  Artifacts
        memoize per (net, board, design) in a bounded LRU.  A malformed
        design raises ``EvalError(INVALID_INPUT)``; a faulted search is
        retried ``max_retries`` times and then raises
        ``EvalError(BACKEND_FAULT)``, never run on the CPU instead.
        """
        if not isinstance(design, (str, AcceleratorSpec)):
            raise EvalError(
                EvalError.INVALID_INPUT,
                "schedule() takes one design (notation string or "
                "AcceleratorSpec)")
        dev = self._device(dev)
        self.stats.bump("schedule_calls")
        try:
            spec = parse(design, len(net), inter_segment_pipelining=
                         inter_segment_pipelining) \
                if isinstance(design, str) else design
            spec.validate(len(net))
            enc = encode_specs([spec], len(net))
        except Exception as e:  # noqa: BLE001 — taxonomy boundary
            raise wrap(e, EvalError.INVALID_INPUT) from e
        key = (self._net_key(net), dev) + tuple(
            a.tobytes() for a in enc.to_numpy())
        with self._table_lock:
            hit = self._schedule_memo.get(key)
        if hit is not None:
            self.stats.bump("schedule_hits")
            return hit
        cfg = self.config
        with telemetry.span("session.schedule") as sp:
            sp.set_attr("net", net.name)
            sp.set_attr("board", dev.name)
            out = self._resilient_call(lambda: schedule_specs(
                [spec], net, self.device_tables(dev),
                tables=self.tables(net), tile=cfg.tile, chunk=cfg.chunk,
                fm_tile_rows=cfg.fm_tile_rows))
            if not np.isfinite([float(out["ref_latency_s"][0]),
                                float(out["coarse_latency_s"][0])]).all():
                raise EvalError(EvalError.NONFINITE_METRICS,
                                "schedule search produced non-finite "
                                "latency")
            art = build_artifact(
                out, 0, net=net, board_name=dev.name,
                design_repr=format_spec(spec, len(net)),
                wordbytes=dev.wordbytes)
            sp.set_attr("candidates", art.n_candidates)
            sp.set_attr("n_refined", art.meta.get("n_refined", 0))
        telemetry.count("schedule.candidates", art.n_candidates)
        telemetry.count("schedule.searches")
        with self._table_lock:
            self._schedule_memo.put(key, art)
        self.stats.bump("schedule_builds")
        return art

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

        ``refine="schedule"`` re-scores the final Pareto front with the
        per-CE temporal-mapping search: the sweep itself still runs on the
        coarse model (the refinement can only lower latency, never
        invalidate a front member), and the result gains a ``refined`` dict
        of schedule-refined latency/access arrays aligned with ``front``.
        A kernel fault raises ``EvalError(BACKEND_FAULT)`` and is fed to the
        breaker; a search is not retried, and nothing falls back to the
        plain version.
        """
        if refine not in (None, "schedule"):
            raise EvalError(EvalError.INVALID_INPUT,
                            f"unknown refine mode {refine!r} "
                            "(expected None or 'schedule')")
        self.stats.bump("explore_calls")
        cfg = self.config
        with telemetry.span("session.explore") as sp:
            sp.set_attr("n", n)
            sp.set_attr("strategy", strategy)
            try:
                res = _explore(net, self._device(dev), n, family=family,
                               seed=seed, chunk=chunk, strategy=strategy,
                               objectives=objectives, config=config,
                               tables=self.tables(net), tile=cfg.tile,
                               eval_chunk=cfg.chunk, mesh=self.mesh)
            except Exception as e:  # noqa: BLE001 — classified below
                if classify(e) != EvalError.BACKEND_FAULT \
                        or isinstance(e, (EvalError, NotImplementedError)):
                    raise
                self.breaker.record_failure()
                raise wrap(e, EvalError.BACKEND_FAULT) from e
            if refine == "schedule" and res.front.size:
                res.refined = self._refine_front(res, net, dev)
                sp.set_attr("refined_front", int(res.front.size))
            return res

    def _refine_front(self, res: DSEResult, net: Network, dev) -> dict:
        """Schedule-refine a DSE result's Pareto front: one batched
        schedule search over the front designs (padded to the ladder
        bucket), returning front-aligned host arrays."""
        dev = self._device(dev)
        cfg = self.config
        nf = int(res.front.size)
        front = res.batch.take(torch.as_tensor(res.front))
        padded = _pad_rows(front, _bucket(nf, cfg.tile))
        with telemetry.span("session.schedule_front") as fsp:
            fsp.set_attr("designs", nf)
            out = self._resilient_call(lambda: schedule_batch(
                padded.to(self.device), self.tables(net),
                self.device_tables(dev), cfg.fm_tile_rows, tile=cfg.tile,
                chunk=cfg.chunk))
            host = {k: out[k][:nf].cpu().numpy() for k in (
                "ref_latency_s", "coarse_latency_s", "ref_throughput_ips",
                "ref_access_bytes", "coarse_access_bytes", "valid_l")}
        telemetry.count("schedule.candidates",
                        int(host["valid_l"].sum()) * NCAND)
        lat, coarse = host["ref_latency_s"], host["coarse_latency_s"]
        return {
            "latency_s": lat,
            "coarse_latency_s": coarse,
            "throughput_ips": host["ref_throughput_ips"],
            "access_bytes": host["ref_access_bytes"],
            "coarse_access_bytes": host["coarse_access_bytes"],
            "saving_frac": np.where(coarse > 0.0,
                                    1.0 - lat / np.maximum(coarse, 1e-30),
                                    0.0),
        }

    # ---- multi-CNN co-scheduling -----------------------------------------
    def deploy(self, nets, n: int = 4096, dev: DeviceSpec | None = None, *,
               strategy: str = "search", seed: int = 0, chunk: int = 512,
               objectives: tuple[str, ...] | None = None,
               objective: str = "serving", config=None, weights=None,
               slo_s=None) -> JointDSEResult:
        """Multi-CNN co-scheduling DSE on the session's device: ``n``
        deployments of ``nets`` sharing board ``dev``, by arm
        (``strategy``): ``"search"`` (designs and the spatial split evolve
        together), ``"equal_split"`` (the split frozen to 1/M),
        ``"temporal"`` (round-robin time shares), ``"hybrid"`` (dedicated
        slices and one shared slice) or ``"random"`` (``chunk``
        deployments drawn at a time).  A ``MultinetSearchConfig`` in
        ``config`` is authoritative for the guided arms (only the budget
        comes from ``n``); ``objective="slo"`` drives the front by graded
        SLO attainment.  Returns a :class:`JointDSEResult`.  The same seed
        draws the same designs and shares as the JAX package's
        ``Session.deploy``.

        The tables are the session's memoized ``MultiNetTables``
        (:meth:`multi_tables`).  Each model lane of each generation is one
        batch-path call, one search-kernel launch a chunk on the card.  A
        kernel fault raises ``EvalError(BACKEND_FAULT)`` and is fed to the
        breaker; a search is not retried, and nothing falls back to the
        plain version.
        """
        # the tables must carry the same weights/SLOs/max_m the search
        # will use, whether they arrive via config or via the keywords
        w = config.weights if config is not None else weights
        s = config.slo_s if config is not None else slo_s
        mm = config.max_m if config is not None else None
        self.stats.bump("deploy_calls")
        cfg = self.config
        with telemetry.span("session.deploy") as sp:
            sp.set_attr("n", n)
            sp.set_attr("models", len(list(nets)))
            sp.set_attr("strategy", strategy)
            try:
                mt = self.multi_tables(nets, weights=w, slo_s=s, max_m=mm)
                return _joint_explore(
                    list(nets), self._device(dev), n, strategy=strategy,
                    seed=seed, chunk=chunk,
                    objectives=JOINT_OBJECTIVES if objectives is None
                    else objectives,
                    objective=objective, config=config, weights=weights,
                    slo_s=slo_s, mtables=mt, tile=cfg.tile,
                    eval_chunk=cfg.chunk, mesh=self.mesh)
            except Exception as e:  # noqa: BLE001 — classified below
                if classify(e) != EvalError.BACKEND_FAULT \
                        or isinstance(e, (EvalError, NotImplementedError)):
                    raise
                self.breaker.record_failure()
                raise wrap(e, EvalError.BACKEND_FAULT) from e

    # ---- queued requests (the serve-many-users path) ---------------------
    def submit(self, designs, net: Network,
               dev: DeviceSpec | None = None, *,
               inter_segment_pipelining: bool = True,
               deadline_s: float | None = None,
               priority: str = "interactive") -> Future:
        """Queue an evaluation request; returns a ``Future``.

        A background drain thread collects everything queued within the
        linger window (fixed ``linger_s``, or arrival-rate adaptive when
        ``linger_max_s`` is set), coalesces it (small same-(net, board)
        requests merge into shared chunks, oversized ones split at
        ``chunk``, each chunk padded to its own ladder shape) and
        evaluates the megabatch on the session's device,
        one search-kernel launch a chunk on the card.  The future resolves
        to ``{metric: np.ndarray}`` over the submitted specs, equal to
        :meth:`evaluate` on them; a single spec or string resolves to
        ``{metric: float}``.

        ``priority`` is the request's lane: ``"interactive"`` requests are
        planned and delivered ahead of ``"batch"`` ones in every drain.

        Malformed designs raise ``EvalError(INVALID_INPUT)`` here,
        synchronously; with ``max_queue`` set, a full queue raises
        ``EvalError(QUEUE_FULL)``; ``deadline_s`` (by default the
        config's) fails the future with ``EvalError(DEADLINE_EXCEEDED)``
        if the result cannot be delivered in time.  A megabatch that
        faults is re-run request by request on the same device, each
        under the retry policy: a kernel fault ends as
        ``EvalError(BACKEND_FAULT)`` on the futures, never as a result of
        the plain version.
        """
        scalar = isinstance(designs, (str, AcceleratorSpec))
        raw = [designs] if scalar else list(designs)
        with telemetry.span("session.submit") as sp:
            sp.set_attr("designs", len(raw))
            sp.set_attr("priority", priority)
            return self._submit(raw, net, dev, scalar,
                                inter_segment_pipelining, deadline_s,
                                priority)

    def _submit(self, raw, net, dev, scalar, inter_segment_pipelining,
                deadline_s, priority="interactive") -> Future:
        if priority not in PRIORITIES:
            raise EvalError(EvalError.INVALID_INPUT,
                            f"unknown priority {priority!r}; "
                            f"known: {PRIORITIES}")
        try:
            specs = [parse(d, len(net), inter_segment_pipelining=
                           inter_segment_pipelining)
                     if isinstance(d, str) else d for d in raw]
        except Exception as e:  # noqa: BLE001 — taxonomy boundary
            raise wrap(e, EvalError.INVALID_INPUT) from e
        if not specs:
            # an empty job inside a megabatch would fail its peers too
            raise EvalError(EvalError.INVALID_INPUT,
                            "no designs to submit (empty list)")
        cfg = self.config
        if deadline_s is None:
            deadline_s = cfg.deadline_s
        deadline = None if deadline_s is None \
            else time.monotonic() + deadline_s
        req = _Request(specs, net, self._device(dev), Future(), scalar,
                       deadline, priority)
        with self._cv:
            if self._closed:
                raise RuntimeError(
                    "session closed: submit() is refused after close() "
                    "(the drain loop is stopped; synchronous evaluate() "
                    "still works)")
            if cfg.max_queue is not None \
                    and len(self._pending) + len(self._jobs) \
                    >= cfg.max_queue:
                self.stats.bump("rejected")
                telemetry.event("resilience.rejected",
                                {"queue": len(self._pending)})
                raise EvalError(
                    EvalError.QUEUE_FULL,
                    f"submit queue full ({cfg.max_queue} pending "
                    f"requests); retry after the queue drains")
            self._arrivals.observe(time.monotonic())
            self._pending.append(req)
            telemetry.gauge("session.queue_depth", len(self._pending))
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._drain_loop,
                    name="repro-torch-session-drain", daemon=True)
                self._worker.start()
            self._cv.notify_all()
        self.stats.bump("submits")
        return req.future

    # ---- the batch lane: long search jobs --------------------------------
    def submit_search(self, nets, n: int = 100_000,
                      dev: DeviceSpec | None = None, *,
                      deadline_s: float | None = None,
                      checkpoint_path: str | None = None,
                      checkpoint_interval: int = 8,
                      **kw) -> Future:
        """Queue a long DSE job on the batch lane: :meth:`explore` for one
        ``Network``, :meth:`deploy` for a list of them; returns a
        ``Future`` resolving to its :class:`DSEResult` or
        :class:`JointDSEResult`.

        Jobs run first in, first out on their own worker thread, so the
        drain of :meth:`submit` never waits behind a 100k-design search;
        the job's evaluations use the session's memoized tables and
        device.  ``checkpoint_path`` makes a ``strategy="search"`` job
        resumable: the search snapshots every ``checkpoint_interval``
        generations, and a resubmitted job resumes from the snapshot bit
        for bit.  ``max_queue`` counts queued jobs; a job whose
        ``deadline_s`` passes while it is queued fails with
        ``DEADLINE_EXCEEDED`` before it spends any budget.
        """
        is_single = isinstance(nets, (Network, NetTables))
        kind = "explore" if is_single else "deploy"
        if checkpoint_path is not None:
            if kw.get("strategy", "random" if is_single else "search") \
                    != "search":
                raise EvalError(
                    EvalError.INVALID_INPUT,
                    "checkpoint_path requires strategy='search' (the "
                    "random sweep has no loop state to snapshot)")
            config = kw.get("config")
            if config is None:
                config = SearchConfig() if is_single \
                    else MultinetSearchConfig()
                if "seed" in kw:
                    config = replace(config, seed=kw["seed"])
            kw["config"] = replace(config,
                                   checkpoint_path=checkpoint_path,
                                   checkpoint_interval=checkpoint_interval,
                                   resume=True)

        def job():
            if kind == "explore":
                return self.explore(nets, n, dev, **kw)
            return self.deploy(nets, n, dev, **kw)

        cfg = self.config
        deadline = None if deadline_s is None \
            else time.monotonic() + deadline_s
        j = _SearchJob(job, Future(), deadline, label=kind)
        with self._job_cv:
            if self._closed:
                raise RuntimeError(
                    "session closed: submit_search() is refused after "
                    "close()")
            if cfg.max_queue is not None \
                    and len(self._jobs) + len(self._pending) \
                    >= cfg.max_queue:
                self.stats.bump("rejected")
                telemetry.event("resilience.rejected",
                                {"queue": len(self._jobs),
                                 "lane": "batch"})
                raise EvalError(
                    EvalError.QUEUE_FULL,
                    f"search-job queue full ({cfg.max_queue} pending); "
                    f"retry after the queue drains")
            self._jobs.append(j)
            telemetry.gauge("session.job_queue_depth", len(self._jobs))
            if self._job_worker is None:
                self._job_worker = threading.Thread(
                    target=self._job_loop, name="repro-torch-session-jobs",
                    daemon=True)
                self._job_worker.start()
            self._job_cv.notify_all()
        self.stats.bump("search_jobs")
        return j.future

    def _job_loop(self) -> None:
        while True:
            with self._job_cv:
                while not self._jobs and not self._closed:
                    self._job_cv.wait()
                if not self._jobs:        # closed and drained
                    return
                j = self._jobs.pop(0)
                self._job_running = True
            try:
                self._run_job(j)
            finally:
                with self._job_cv:
                    self._job_running = False
                    self._job_cv.notify_all()

    def _run_job(self, j: _SearchJob) -> None:
        if not j.future.set_running_or_notify_cancel():
            return
        if j.deadline is not None and time.monotonic() > j.deadline:
            self.stats.bump("deadline_missed")
            telemetry.event("resilience.deadline_missed",
                            {"where": "job_queued"})
            j.future.set_exception(EvalError(
                EvalError.DEADLINE_EXCEEDED,
                "deadline passed while the search job was queued"))
            return
        with telemetry.span("session.search_job") as sp:
            sp.set_attr("kind", j.label)
            telemetry.observe("session.job_queue_wait_s",
                              time.monotonic() - j.t_enq)
            try:
                out = j.fn()
            except BaseException as e:  # noqa: BLE001 — job isolation
                j.future.set_exception(wrap(e))
                if not isinstance(e, Exception):
                    raise
            else:
                j.future.set_result(out)

    # ---- the drain -------------------------------------------------------
    def drain(self) -> int:
        """Synchronously megabatch everything queued now (what the drain
        thread runs); returns the number of requests served.  Interactive
        requests are planned and delivered ahead of batch ones (stable
        within a lane)."""
        with self._cv:
            reqs, self._pending = self._pending, []
        if reqs:
            reqs.sort(key=lambda r: PRIORITIES.index(r.priority))
            self._run_megabatch(reqs)
        return len(reqs)

    def _linger(self) -> float:
        """The next drain's linger window: fixed ``linger_s``, or the
        arrival-rate policy when ``linger_max_s`` is armed."""
        cfg = self.config
        if cfg.linger_max_s is None:
            return cfg.linger_s
        return self._arrivals.linger(cfg.linger_max_s)

    def _drain_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
            # linger so concurrent submitters land in the same megabatch
            time.sleep(self._linger())
            self.drain()

    def _deliver(self, r: _Request, out: dict) -> None:
        if not r.future.set_running_or_notify_cancel():
            return
        if r.scalar:
            out = {k: float(v[0]) for k, v in out.items()}
        r.future.set_result(out)

    def _fail(self, r: _Request, exc: BaseException) -> None:
        if r.future.set_running_or_notify_cancel():
            r.future.set_exception(wrap(exc))

    def _expire(self, reqs: list[_Request]) -> list[_Request]:
        """Fail requests whose deadline already passed (DEADLINE_EXCEEDED)
        before spending any evaluation on them; returns the live rest."""
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self.stats.bump("deadline_missed")
                telemetry.event("resilience.deadline_missed",
                                {"where": "queued"})
                self._fail(r, EvalError(
                    EvalError.DEADLINE_EXCEEDED,
                    "deadline passed while the request was queued"))
            else:
                live.append(r)
        return live

    def _finish(self, r: _Request, out: dict) -> None:
        """Finite-guard and deadline-check one request's result, then
        deliver: NaN/Inf rows fail their own future, not the megabatch,
        and a passed deadline refuses late delivery."""
        bad = nonfinite_keys(out)
        if bad:
            self._fail(r, EvalError(EvalError.NONFINITE_METRICS,
                                    f"non-finite metrics {bad}"))
            return
        if r.deadline is not None and time.monotonic() > r.deadline:
            self.stats.bump("deadline_missed")
            telemetry.event("resilience.deadline_missed",
                            {"where": "evaluated"})
            self._fail(r, EvalError(EvalError.DEADLINE_EXCEEDED,
                                    "deadline passed during evaluation"))
            return
        self.stats.bump("megabatch_requests")
        telemetry.observe("session.request_latency_s",
                          time.monotonic() - r.t_enq)
        self._deliver(r, out)

    def _eval_one(self, r: _Request) -> dict:
        cfg = self.config
        return _evaluate_specs(r.specs, r.net, self.device_tables(r.dev),
                               cfg.chunk, tables=self.tables(r.net),
                               tile=cfg.tile, fm_tile_rows=cfg.fm_tile_rows,
                               mesh=self.mesh)

    def _run_megabatch(self, reqs: list[_Request]) -> None:
        # the outer net: whatever goes wrong below, every future resolves
        try:
            self._run_megabatch_inner(reqs)
        except BaseException as e:  # noqa: BLE001
            for r in reqs:
                if not r.future.done():
                    self._fail(r, e)
            if not isinstance(e, Exception):   # KeyboardInterrupt etc.
                raise

    def _run_megabatch_inner(self, reqs: list[_Request]) -> None:
        with telemetry.span("session.megabatch") as sp:
            sp.set_attr("requests", len(reqs))
            self._run_megabatch_spanned(reqs, sp)

    def _run_megabatch_spanned(self, reqs: list[_Request], sp) -> None:
        cfg = self.config
        reqs = self._expire(reqs)
        if not reqs:
            return
        if telemetry.enabled():
            now = time.monotonic()
            for r in reqs:
                telemetry.observe("session.queue_wait_s", now - r.t_enq)
            telemetry.observe("session.megabatch_fill",
                              len(reqs), bounds=tuple(
                                  float(2 ** i) for i in range(16)))
            telemetry.gauge("session.megabatch_size", len(reqs))
            telemetry.gauge("session.linger_s", cfg.linger_s)
        # memoized tables for both axes, built per request under its own
        # guard: one request's broken net or board fails its future only
        ready: list[tuple[_Request, object, object]] = []
        for r in reqs:
            try:
                tab = self.tables(r.net)
                dtab = self.device_tables(r.dev)
            except Exception as e:  # noqa: BLE001
                self._fail(r, wrap(e, EvalError.INVALID_INPUT))
            else:
                ready.append((r, tab, dtab))
        if not ready:
            return
        jobs, scatter = self._coalesce_jobs(ready, sp)
        try:
            results = self._resilient_call(lambda: [
                _evaluate_specs(specs, net, dtab, cfg.chunk, tables=tab,
                                tile=cfg.tile, pad_to=pad,
                                fm_tile_rows=cfg.fm_tile_rows,
                                mesh=self.mesh)
                for specs, net, tab, dtab, pad in jobs])
        except Exception:  # noqa: BLE001 — isolate the bad request(s)
            # one malformed request must not fail its co-queued peers:
            # each runs alone, on the session's device, under the same
            # retry policy, so each future gets its own result or error
            for r, _, _ in ready:
                try:
                    out = self._resilient_call(lambda r=r: self._eval_one(r))
                except Exception as e:  # noqa: BLE001
                    self._fail(r, e)
                else:
                    self._finish(r, out)
            return
        self.stats.bump("megabatches")
        scatter(results)

    def _coalesce_jobs(self, ready, sp):
        """Plan the coalesced megabatch: requests with the same memoized
        ``NetTables`` and ``DeviceTables`` pack into shared chunks,
        oversized ones split at ``chunk`` (``core.coalesce``).  Returns
        ``(jobs, scatter)``: one ``(specs, net, NetTables, DeviceTables,
        pad)`` tuple per chunk, ``pad`` its own ladder shape, and
        ``scatter(results)``, which slices the per-chunk metric arrays
        back to each request's future, in its own spec order, every
        request answered once."""
        cfg = self.config
        nd = self.mesh.ndevices if self.mesh.is_sharded else 1
        keyed = [((id(tab), id(dtab)), len(r.specs))
                 for r, tab, dtab in ready]
        plan = plan_megabatch(keyed, cfg.chunk, cfg.tile, nd)
        by_key = {}
        for i, (key, _) in enumerate(keyed):
            by_key.setdefault(key, i)
        jobs = []
        for c in plan.chunks:
            specs = []
            for p in c.parts:
                specs.extend(ready[p.req][0].specs[p.lo:p.hi])
            lead, tab, dtab = ready[by_key[c.group]]
            jobs.append((specs, lead.net, tab, dtab, c.pad))
        self.stats.bump("coalesced_chunks", len(plan.chunks))
        if plan.merges:
            self.stats.bump("coalesced_merges", plan.merges)
        if plan.splits:
            self.stats.bump("coalesced_splits", plan.splits)
        sp.set_attr("chunks", len(plan.chunks))
        sp.set_attr("shared_pad", plan.shared_pad)

        def scatter(results):
            pieces: dict[int, list] = {i: [] for i in range(len(ready))}
            for c, out in zip(plan.chunks, results):
                off = 0
                for p in c.parts:
                    n = len(p)
                    pieces[p.req].append(
                        (p.lo, {k: v[off:off + n]
                                for k, v in out.items()}))
                    off += n
            for i, (r, _, _) in enumerate(ready):
                parts = sorted(pieces[i], key=lambda t: t[0])
                outs = [d for _, d in parts]
                if len(outs) == 1:
                    self._finish(r, outs[0])
                else:
                    self._finish(r, {k: np.concatenate(
                        [o[k] for o in outs]) for k in outs[0]})

        return jobs, scatter

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
        counts["rejected"] = self.stats.rejected
        counts["retried"] = self.stats.retried
        counts["degraded"] = self.stats.degraded
        counts["deadline_missed"] = self.stats.deadline_missed
        return counts

    def cache_stats(self) -> dict[str, dict[str, int]]:
        """Size / bound / eviction counters of the table memos and the
        schedule-artifact memo."""
        with self._table_lock:
            return {"net_tables": self._net_tables.stats(),
                    "device_tables": self._dev_tables.stats(),
                    "multi_tables": self._multi_tables.stats(),
                    "schedule_artifacts": self._schedule_memo.stats()}

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


# --------------------------------------------------------------------------
# the process-wide default session
# --------------------------------------------------------------------------
_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Session | None = None


def default_session(**overrides) -> Session:
    """The process-wide shared session.

    Created on first call; ``overrides`` (EvalConfig fields or ``dev=``)
    apply only then: asking for other settings once it exists is an
    error, construct a private :class:`Session` instead."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Session(**overrides)
        elif overrides:
            raise ValueError(
                "the default session already exists; construct "
                "Session(...) directly for different settings")
        return _DEFAULT
