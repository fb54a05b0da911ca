"""Bounded LRU cache for the Session's memoized tables.

A long-lived process under many distinct (net, board) keys would grow an
unbounded memo without limit; :class:`BoundedLRU` evicts the
least-recently-used entry past ``maxsize`` and counts evictions.  Thread
safety is the owner's job: the Session holds its table lock across
get+put.  The bound resolves from ``REPRO_CACHE_TABLES`` once, when the
Session is built.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable

#: env knob for the table-cache bound (read once, in ``EvalConfig.resolved``)
TABLES_ENV = "REPRO_CACHE_TABLES"

#: default bound: no interactive session or test ever evicts
DEFAULT_MAX_TABLES = 256


def env_bound(env: str, default: int) -> int:
    """Resolve a cache bound from the environment.  ``0`` (or a negative
    value) means *unbounded*: the cache never evicts."""
    raw = os.environ.get(env)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError as e:
        raise ValueError(f"{env} must be an integer, got {raw!r}") from e


class BoundedLRU:
    """An ordered mapping that evicts its least-recently-used entry past
    ``maxsize``.  ``maxsize <= 0`` disables eviction (plain memo dict).
    Not thread-safe by itself."""

    def __init__(self, maxsize: int = 0, *,
                 on_evict: Callable[[object, object], None] | None = None):
        self.maxsize = int(maxsize)
        self.on_evict = on_evict
        self.evictions = 0
        self._d: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def get(self, key, default=None):
        """Look up ``key``, refreshing its recency on a hit."""
        try:
            val = self._d[key]
        except KeyError:
            return default
        self._d.move_to_end(key)
        return val

    def put(self, key, value) -> None:
        """Insert (or refresh) ``key`` and evict LRU entries past the
        bound, calling ``on_evict(key, value)`` for each victim."""
        self._d[key] = value
        self._d.move_to_end(key)
        if self.maxsize <= 0:
            return
        while len(self._d) > self.maxsize:
            k, v = self._d.popitem(last=False)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(k, v)

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def items(self):
        return self._d.items()

    def clear(self) -> None:
        self._d.clear()

    def stats(self) -> dict[str, int]:
        """Size / bound / eviction counters, as ``observability()``
        reports them."""
        return {"size": len(self._d), "maxsize": self.maxsize,
                "evictions": self.evictions}
