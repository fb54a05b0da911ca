"""Resilience primitives of the port: the error taxonomy, retries, the
circuit breaker, the finite guard and the search checkpoints.

* :class:`EvalError` -- how every Session-level failure is expressed
  (``INVALID_INPUT`` / ``NONFINITE_METRICS`` / ``BACKEND_FAULT`` /
  ``DEADLINE_EXCEEDED`` / ``QUEUE_FULL``), with :func:`classify`/:func:`wrap`
  mapping an arbitrary exception onto it (the error boundary of every
  ``Session.evaluate`` path);
* :func:`retry_delay` -- the exponential backoff the Session sleeps
  between retries of a faulted kernel;
* :class:`CircuitBreaker` -- counts consecutive backend faults and trips
  open past a threshold, deterministically (calls, not wall clock).  The
  port has no fallback backend, so the breaker records and reports;
* :func:`nonfinite_keys` -- the NaN/Inf check of the batch path;
* :func:`save_checkpoint` / :func:`load_checkpoint` -- the versioned,
  sha256-checked, atomically renamed snapshot file ``dse.search`` writes,
  in the JAX package's format, with :func:`rng_state`/:func:`rng_from_state`
  so a resumed search replays the exact random stream.
"""
from __future__ import annotations

import copy
import hashlib
import os
import pickle
import threading

import numpy as np

from . import telemetry

__all__ = [
    "EvalError", "classify", "wrap", "CircuitBreaker", "retry_delay",
    "nonfinite_keys", "save_checkpoint", "load_checkpoint", "rng_state",
    "rng_from_state", "CHECKPOINT_VERSION",
]

# --------------------------------------------------------------------------
# error taxonomy
# --------------------------------------------------------------------------
class EvalError(RuntimeError):
    """A structured evaluation failure.

    ``code`` is one of the class attributes below; the rendered message is
    ``[CODE] detail``.  Callers branch on ``err.code``, never on message
    text.
    """

    #: the request itself is malformed: unparseable notation, an invalid
    #: ``DesignBatch`` row, an empty design list, a broken net/board
    INVALID_INPUT = "INVALID_INPUT"
    #: evaluation produced NaN/Inf metrics for this request's designs
    NONFINITE_METRICS = "NONFINITE_METRICS"
    #: the evaluation backend (kernel build/launch) faulted
    BACKEND_FAULT = "BACKEND_FAULT"
    #: the request's deadline passed before its result could be delivered
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"
    #: admission control: the bounded submit queue is full
    QUEUE_FULL = "QUEUE_FULL"

    CODES = (INVALID_INPUT, NONFINITE_METRICS, BACKEND_FAULT,
             DEADLINE_EXCEEDED, QUEUE_FULL)

    def __init__(self, code: str, message: str):
        if code not in self.CODES:
            raise ValueError(f"unknown EvalError code {code!r}; "
                             f"known: {self.CODES}")
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message


#: exception families that mean "the caller's input was bad" rather than
#: "the backend broke"
_INPUT_ERRORS = (ValueError, TypeError, KeyError, IndexError,
                 AttributeError)


def classify(exc: BaseException) -> str:
    """Map an arbitrary exception onto an :class:`EvalError` code."""
    if isinstance(exc, EvalError):
        return exc.code
    if isinstance(exc, _INPUT_ERRORS):
        return EvalError.INVALID_INPUT
    return EvalError.BACKEND_FAULT


def wrap(exc: BaseException, code: str | None = None) -> EvalError:
    """Wrap ``exc`` as an :class:`EvalError` (pass-through if it already
    is one), keeping the original message so callers matching on detail
    text keep working."""
    if isinstance(exc, EvalError):
        return exc
    return EvalError(code or classify(exc),
                     f"{type(exc).__name__}: {exc}")


# --------------------------------------------------------------------------
# retry backoff + circuit breaker (deterministic: counts, not wall clock)
# --------------------------------------------------------------------------
#: base delay of the exponential retry backoff (doubles per attempt)
RETRY_BASE_DELAY_S = 0.05
#: backoff ceiling
RETRY_MAX_DELAY_S = 2.0


def retry_delay(attempt: int) -> float:
    """Exponential backoff: ``base * 2**(attempt-1)``, capped.  ``attempt``
    is 1-based (the first *retry* is attempt 1)."""
    return min(RETRY_BASE_DELAY_S * (2.0 ** max(attempt - 1, 0)),
               RETRY_MAX_DELAY_S)


class CircuitBreaker:
    """Trip open after ``fail_threshold`` consecutive backend faults; a
    success closes it again.  The JAX package's breaker also admits
    recovery probes while open, for its fallback backend; the port has no
    fallback (a call on a CUDA tensor never goes to the plain version), so
    its breaker records and reports only.

    Deterministic by construction -- state advances on *calls*, never on
    wall-clock time -- so fault-injection tests replay exactly.  Thread
    safe.
    """

    def __init__(self, fail_threshold: int = 3):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        self.fail_threshold = fail_threshold
        self._lock = threading.Lock()
        self._consecutive = 0
        self._open = False
        #: total times the breaker tripped open (observability)
        self.trips = 0

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._open

    def record_success(self) -> None:
        with self._lock:
            closed = self._open
            self._consecutive = 0
            self._open = False
        if closed:  # emit outside the lock: telemetry has its own
            telemetry.event("resilience.breaker_close",
                            {"trips": self.trips})

    def record_failure(self) -> None:
        tripped = False
        with self._lock:
            self._consecutive += 1
            if not self._open and self._consecutive >= self.fail_threshold:
                self._open = True
                self.trips += 1
                tripped = True
        if tripped:
            telemetry.event("resilience.breaker_open",
                            {"consecutive": self.fail_threshold,
                             "trips": self.trips})


# --------------------------------------------------------------------------
# finite guards
# --------------------------------------------------------------------------
def nonfinite_keys(out: dict) -> list[str]:
    """Metric keys of ``out`` (host arrays) containing any NaN/Inf entry."""
    return [k for k, v in out.items() if not np.isfinite(v).all()]


# --------------------------------------------------------------------------
# versioned checkpoints (what the search loop snapshots through)
# --------------------------------------------------------------------------
CHECKPOINT_MAGIC = b"RPROCKPT\n"
CHECKPOINT_VERSION = 1
_DIGEST_LEN = hashlib.sha256().digest_size


def save_checkpoint(path: str, kind: str, state: dict,
                    meta: dict | None = None) -> str:
    """Atomically write a checkpoint: magic + sha256(payload) + pickled
    ``{format, version, kind, meta, state}``.  The temp-file +
    ``os.replace`` dance means a kill mid-write leaves the previous
    checkpoint intact — a reader sees the old snapshot or the new one,
    never a torn file."""
    payload = pickle.dumps(
        {"format": "repro-checkpoint", "version": CHECKPOINT_VERSION,
         "kind": kind, "meta": dict(meta or {}), "state": state},
        protocol=pickle.HIGHEST_PROTOCOL)
    digest = hashlib.sha256(payload).digest()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(CHECKPOINT_MAGIC)
        f.write(digest)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if telemetry.enabled():
        telemetry.count(f"checkpoint.writes.{kind}")
        telemetry.event("checkpoint.write",
                        {"kind": kind, "bytes": len(payload)})
    return path


def load_checkpoint(path: str, kind: str | None = None) -> dict:
    """Read + verify a checkpoint; returns ``{kind, meta, state}``.

    Raises :class:`EvalError` (``INVALID_INPUT``) on a missing file, a
    corrupt/torn payload (checksum mismatch), a format/version mismatch,
    or — when ``kind`` is given — a checkpoint of the wrong kind.
    """
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise EvalError(EvalError.INVALID_INPUT,
                        f"cannot read checkpoint {path}: {e}") from e
    if not blob.startswith(CHECKPOINT_MAGIC):
        raise EvalError(EvalError.INVALID_INPUT,
                        f"{path} is not a repro checkpoint (bad magic)")
    start = len(CHECKPOINT_MAGIC)
    digest = blob[start:start + _DIGEST_LEN]
    payload = blob[start + _DIGEST_LEN:]
    if hashlib.sha256(payload).digest() != digest:
        raise EvalError(EvalError.INVALID_INPUT,
                        f"corrupt checkpoint {path} (checksum mismatch)")
    obj = pickle.loads(payload)
    if obj.get("format") != "repro-checkpoint":
        raise EvalError(EvalError.INVALID_INPUT,
                        f"{path}: unknown checkpoint format")
    if obj.get("version") != CHECKPOINT_VERSION:
        raise EvalError(
            EvalError.INVALID_INPUT,
            f"{path}: checkpoint version {obj.get('version')} != "
            f"{CHECKPOINT_VERSION}")
    if kind is not None and obj.get("kind") != kind:
        raise EvalError(EvalError.INVALID_INPUT,
                        f"{path}: checkpoint kind {obj.get('kind')!r} != "
                        f"expected {kind!r}")
    return {"kind": obj["kind"], "meta": obj["meta"], "state": obj["state"]}


def rng_state(rng: np.random.Generator) -> dict:
    """A picklable snapshot of a numpy ``Generator``'s full state."""
    return copy.deepcopy(rng.bit_generator.state)


def rng_from_state(state: dict) -> np.random.Generator:
    """Rebuild a ``Generator`` replaying exactly from :func:`rng_state`."""
    bit_gen = getattr(np.random, state["bit_generator"])()
    bit_gen.state = copy.deepcopy(state)
    return np.random.Generator(bit_gen)
