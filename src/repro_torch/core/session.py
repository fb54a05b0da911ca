"""The front door of the port: a :class:`Session` owns the memoized tables
and the evaluation knobs, and scores designs on one device.

The PyTorch port of the JAX package's ``core/session.py``, trimmed to
evaluation: ``evaluate`` on one spec or notation string (the scalar
Builder, plain Python on the host, whatever the session's device), on a
list of them and on a ``DesignBatch`` (the batch path, on the session's
device); ``build`` and ``explain`` on one design.  The device is explicit:
``cuda`` unless the caller passes ``device="cpu"``, and a Session asked
for ``cuda`` on a machine without a visible card raises instead of running
on the CPU.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..telemetry.report import bottleneck_report
from .batch_eval import (DEFAULT_CHUNK, DEFAULT_TILE, DeviceTables,
                         NetTables, _evaluate_specs, bucket_max_L,
                         evaluate_batch, make_device_tables, make_tables)
from .cache import DEFAULT_MAX_TABLES, TABLES_ENV, BoundedLRU, env_bound
from .device import DeviceSpec
from .dse.encoding import NC, DesignBatch, validate_batch
from .evaluator import _evaluate_design, build_design
from .notation import AcceleratorSpec, parse
from .resilience import EvalError, nonfinite_keys, wrap
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

    def resolved(self) -> "EvalConfig":
        """Check the knobs and pin the env-dependent cache bound."""
        for name in ("tile", "fm_tile_rows", "chunk"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        return replace(
            self, max_cached_tables=env_bound(TABLES_ENV, DEFAULT_MAX_TABLES)
            if self.max_cached_tables is None else self.max_cached_tables)


@dataclass
class SessionStats:
    """Host-side counters of what a session reused vs rebuilt."""

    net_table_builds: int = 0
    net_table_hits: int = 0
    device_table_builds: int = 0
    device_table_hits: int = 0
    net_table_evictions: int = 0
    device_table_evictions: int = 0
    batch_designs: int = 0
    scalar_evals: int = 0


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
        # the table lock is held across check+build+insert
        self._table_lock = threading.Lock()
        bound = self.config.max_cached_tables
        self._net_tables = BoundedLRU(bound, on_evict=lambda *_: self._bump(
            "net_table_evictions"))
        self._dev_tables = BoundedLRU(bound, on_evict=lambda *_: self._bump(
            "device_table_evictions"))

    def _bump(self, name: str, n: int = 1) -> None:
        setattr(self.stats, name, getattr(self.stats, name) + n)

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
                self._bump("net_table_hits")
                return hit
            built = make_tables(net, max_L=bucket, device=self.device)
            self._net_tables.put(key, built)
            self._bump("net_table_builds")
            return built

    def device_tables(self, dev: DeviceSpec | None = None) -> DeviceTables:
        """Memoized ``DeviceTables`` for a board on the session's device."""
        dev = self._device(dev)
        with self._table_lock:
            hit = self._dev_tables.get(dev)
            if hit is not None:
                self._bump("device_table_hits")
                return hit
            built = make_device_tables(dev, device=self.device)
            self._dev_tables.put(dev, built)
            self._bump("device_table_builds")
            return built

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
        card included) as ``BACKEND_FAULT``.  Nothing is retried, and
        nothing falls back to the plain version.
        """
        dev = self._device(dev)
        if isinstance(designs, (str, AcceleratorSpec)):
            self._bump("scalar_evals")
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
            self._bump("batch_designs", designs.batch)
            with _taxonomy():
                return evaluate_batch(
                    designs.to(self.device), self.tables(net),
                    self.device_tables(dev), cfg.fm_tile_rows, tile=cfg.tile,
                    chunk=cfg.chunk)
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
        self._bump("batch_designs", len(specs))
        with _taxonomy():
            out = _evaluate_specs(specs, net, self.device_tables(dev),
                                  cfg.chunk, tables=self.tables(net),
                                  tile=cfg.tile,
                                  fm_tile_rows=cfg.fm_tile_rows)
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
