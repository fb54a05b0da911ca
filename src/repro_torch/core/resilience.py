"""The evaluation error taxonomy and the finite guard.

:class:`EvalError` is how every Session-level failure is expressed, and
:func:`classify`/:func:`wrap` map an arbitrary exception onto it (the
error boundary of every ``Session.evaluate`` path);
:func:`nonfinite_keys` backs the NaN/Inf check of the batch path.
Retries, the circuit breaker and checkpoints are still to be ported.
"""
from __future__ import annotations

import numpy as np


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


def nonfinite_keys(out: dict) -> list[str]:
    """Metric keys of ``out`` (host arrays) containing any NaN/Inf entry."""
    return [k for k, v in out.items() if not np.isfinite(v).all()]
