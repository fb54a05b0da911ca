"""The reduction of a ``torch.profiler`` trace over a stretch of calls:
the device's busy time, each kernel's count and time, and the idle gaps
named by what the host was doing.

The device's busy time is the union of the intervals in which a kernel, a
copy or a fill ran on it.  A gap is named by the innermost host event
open at its middle: a PyTorch op, a CUDA runtime call, or one of the
harness's spans (``bench.evaluate``, ``bench.pull``, ``bench.check``);
a gap outside all of them is ``host: between calls``.
"""
from __future__ import annotations

import time
from collections import defaultdict

#: device events that are not kernels
_NOT_KERNELS = ("Memcpy", "Memset")


def profile_calls(call, n: int, sync) -> dict:
    """Run ``call(i, mark)`` for i in range(n) under the profiler, where
    ``mark(name)`` opens a named span, and reduce the trace.  Returns the
    calls, the profiled wall, and, where the trace holds device events,
    ``busy_s``, ``kernels``, ``kernel_s``, ``by_kernel`` (name -> [count,
    seconds]) and ``idle_gaps`` (name -> seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            call(i, record_function)
        sync()
        wall = time.perf_counter() - t0
    events = list(prof.events())
    # a record_function span is mirrored on the device timeline as a user
    # annotation: it is no device work
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    out = {"calls": n, "wall_s": wall}
    if not dev:
        return out
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    merged = [list(spans[0])]
    for a, b in spans[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    by_kernel = defaultdict(lambda: [0, 0.0])
    for e in dev:
        row = by_kernel[e.name]
        row[0] += 1
        row[1] += (e.time_range.end - e.time_range.start) / 1e6
    kernels = {k: v for k, v in by_kernel.items()
               if not k.startswith(_NOT_KERNELS)}
    out.update(
        busy_s=sum(b - a for a, b in merged) / 1e6,
        kernels=sum(v[0] for v in kernels.values()),
        kernel_s=sum(v[1] for v in kernels.values()),
        by_kernel=dict(by_kernel),
        idle_gaps=_name_gaps(merged, host))
    return out


def _name_gaps(merged, host) -> dict:
    """Seconds of device idleness between the first and the last device
    event, summed by the innermost host event open at each gap's
    middle."""
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in host), key=lambda t: (t[0], -t[1]))
    gaps = defaultdict(float)
    stack, i = [], 0
    # one sweep: host events are pushed in start order and popped once
    # closed, so the stack's top is the innermost event open at ``mid``
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        gaps[stack[-1][2] if stack else "host: between calls"] += \
            (b - a) / 1e6
    return dict(gaps)


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without ``void`` and its argument list, at most
    ``width`` characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    if name.startswith(_NOT_KERNELS):
        return name[:width]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:width]


def top(pairs: dict, n: int = 10) -> list[list]:
    """The ``n`` entries of ``name -> seconds`` with the most seconds, as
    [name, seconds] pairs, kernel names shortened."""
    return [[short_name(k), v] for k, v in
            sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]
