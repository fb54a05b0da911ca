"""The port's megabatch planner (``repro_torch.core.coalesce``) and the
bounded table cache against the JAX package's, on the CPU.

On the same request streams the two planners give the same chunks (group,
parts, rows, pad), the same ``merges``, ``splits`` and ``shared_pad``, and
``validate_plan`` finds no violation; ``ladder_pad`` equals the JAX
package's and the port's own ``batch_eval._bucket`` capped at the chunk;
``ArrivalEstimator`` gives the same linger sequence for the same arrival
times.  ``BoundedLRU``'s mapping methods behave as the JAX package's on
``tests/test_session_cache.py``'s cases.

Streams come from ``hypo_fallback`` (real hypothesis when installed), as
``tests/test_serve_coalesce.py``'s do.
"""
from __future__ import annotations

import pytest
from hypo_fallback import given, settings, st

from repro.core import cache as jcache
from repro.core import coalesce as jco
from repro_torch.core import cache as tcache
from repro_torch.core import coalesce as tco
from repro_torch.core.batch_eval import _bucket

PKGS = {"jax": jco, "port": tco}


def _plan_tuple(plan) -> tuple:
    """A plan as plain tuples, comparable across the two packages'
    (distinct) dataclasses."""
    return (tuple((c.group, tuple((p.req, p.lo, p.hi) for p in c.parts),
                   c.rows, c.pad) for c in plan.chunks),
            plan.merges, plan.splits, plan.shared_pad)


@st.composite
def _streams(draw):
    """(requests, chunk, tile, ndevices): mixed-group request streams
    against arbitrary ladder geometry."""
    tile = draw(st.sampled_from([1, 8, 32, 128]))
    ndevices = draw(st.sampled_from([1, 2, 4]))
    base = tile * ndevices
    chunk = base * draw(st.sampled_from([1, 2, 8]))
    n = draw(st.integers(min_value=1, max_value=12))
    reqs = [(draw(st.sampled_from(["g0", "g1", "g2"])),
             draw(st.integers(min_value=1, max_value=3 * chunk)))
            for _ in range(n)]
    return reqs, chunk, tile, ndevices


@settings(max_examples=80, deadline=None)
@given(_streams())
def test_plan_equals_jax_on_arbitrary_streams(stream):
    reqs, chunk, tile, nd = stream
    got = tco.plan_megabatch(reqs, chunk, tile, nd)
    want = jco.plan_megabatch(reqs, chunk, tile, nd)
    assert _plan_tuple(got) == _plan_tuple(want)
    assert tco.validate_plan(got, reqs, chunk, tile, nd) == []
    assert sum(c.rows for c in got.chunks) == sum(s for _, s in reqs)
    assert got.shared_pad <= chunk


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=1, max_value=4096),
       st.sampled_from([1, 2, 8, 32, 128]),
       st.sampled_from([1, 2, 4]),
       st.sampled_from([128, 512, 2048, 4096]))
def test_ladder_pad_equals_jax_and_the_bucket(rows, tile, nd, chunk):
    if rows > chunk:
        for mod in PKGS.values():
            with pytest.raises(ValueError, match="exceed"):
                mod.ladder_pad(rows, chunk, tile, nd)
        return
    pad = tco.ladder_pad(rows, chunk, tile, nd)
    assert pad == jco.ladder_pad(rows, chunk, tile, nd)
    assert rows <= pad <= chunk
    if nd == 1:
        # the shapes the port's spec-list path pads to
        assert pad == min(_bucket(rows, tile), chunk)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_plan_merges_tiny_and_splits_oversized(pkg):
    co = PKGS[pkg]
    reqs = [("g", 1), ("g", 1), ("g", 1), ("g", 70)]
    plan = co.plan_megabatch(reqs, chunk=32, tile=8)
    assert co.validate_plan(plan, reqs, 32, 8) == []
    assert plan.merges >= 3
    assert plan.splits == 1          # only the 70-spec request splits
    assert all(c.pad <= 32 for c in plan.chunks)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_plan_never_mixes_groups(pkg):
    co = PKGS[pkg]
    reqs = [("a", 2), ("b", 2), ("a", 2)]
    plan = co.plan_megabatch(reqs, chunk=32, tile=8)
    assert all(p.req in (0, 2) for p in plan.chunks[0].parts)
    assert plan.merges == 2 and len(plan.chunks) == 2


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_plan_rejects_bad_input(pkg):
    co = PKGS[pkg]
    with pytest.raises(ValueError, match="size 0"):
        co.plan_megabatch([("g", 0)], chunk=32, tile=8)
    with pytest.raises(ValueError, match="chunk must be"):
        co.plan_megabatch([("g", 1)], chunk=0, tile=8)
    with pytest.raises(ValueError, match="tile must be"):
        co.plan_megabatch([("g", 1)], chunk=32, tile=0)


def test_validate_plan_reports_what_jax_reports():
    """A tampered plan: both validators name the same violations."""
    reqs = [("g", 5), ("h", 3)]
    bad = tco.Plan((tco.Chunk("g", (tco.Part(0, 0, 4),), 5, 3),
                    tco.Chunk("g", (tco.Part(1, 0, 3),), 3, 8)), 0, 0)
    jbad = jco.Plan((jco.Chunk("g", (jco.Part(0, 0, 4),), 5, 3),
                     jco.Chunk("g", (jco.Part(1, 0, 3),), 3, 8)), 0, 0)
    got = tco.validate_plan(bad, reqs, 8, 8)
    assert got == jco.validate_plan(jbad, reqs, 8, 8)
    assert len(got) >= 5


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=0.0, max_value=0.2), min_size=1,
                max_size=40),
       st.floats(min_value=0.0, max_value=0.1))
def test_arrival_estimator_lingers_as_jax(gaps, max_s):
    got, want = tco.ArrivalEstimator(), jco.ArrivalEstimator()
    t = 0.0
    for dt in gaps:
        t += dt
        got.observe(t)
        want.observe(t)
        assert got.linger(max_s) == want.linger(max_s)
        assert got.interarrival_s == want.interarrival_s
        assert 0.0 <= got.linger(max_s) <= max_s


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_arrival_estimator_adapts(pkg):
    est = PKGS[pkg].ArrivalEstimator()
    assert est.linger(0.05) == 0.05          # cold queue: the full window
    t = 0.0
    for _ in range(32):
        est.observe(t)
        t += 0.1
    slow = est.linger(1.0)
    for _ in range(64):
        est.observe(t)
        t += 0.001
    assert est.linger(1.0) < slow            # a hot stream shrinks it
    with pytest.raises(ValueError, match="alpha"):
        PKGS[pkg].ArrivalEstimator(alpha=0.0)


# --------------------------------------------------------------------------
# BoundedLRU: the mapping methods the session cache tests use
# --------------------------------------------------------------------------
CACHES = {"jax": jcache, "port": tcache}


def _lru_trace(mod) -> list:
    gone = []
    lru = mod.BoundedLRU(2, on_evict=lambda k, v: gone.append(k))
    trace = [len(lru), "a" in lru]
    lru.put("a", 1)
    lru.put("b", 2)
    trace += [len(lru), "a" in lru, lru.get("a")]
    lru.put("c", 3)                  # "b" is the least recent: evicted
    trace += [gone[:], list(lru.keys()), list(lru.values()),
              list(lru.items()), "b" in lru, lru.stats()]
    lru.clear()
    trace += [len(lru), list(lru.items()), lru.stats()]
    unbounded = mod.BoundedLRU(0)
    for i in range(500):
        unbounded.put(i, i)
    trace += [len(unbounded), unbounded.evictions, 499 in unbounded]
    return trace


@pytest.mark.parametrize("pkg", sorted(CACHES))
def test_bounded_lru_mapping_methods(pkg):
    trace = _lru_trace(CACHES[pkg])
    assert trace == _lru_trace(jcache)
    assert trace[:2] == [0, False]
    assert trace[5:9] == [["b"], ["a", "c"], [1, 3], [("a", 1), ("c", 3)]]
    assert trace[11:14] == [0, [], {"size": 0, "maxsize": 2,
                                    "evictions": 1}]
    assert trace[14:] == [500, 0, True]
