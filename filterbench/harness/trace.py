"""Reduce one traced window's profiler events to the records that the
per-layer metric readers take.

Kernels are attributed to the harness's ranges by their launch: a device
operation's correlation id names the host call that launched it (a CUDA
runtime or driver launch, or failing that the CPU op linked to it), and
the range whose host interval holds that call's start gets the
operation's device time.  This works for the port's ``ctypes`` kernels
as well as for PyTorch's own, which the profiler does not nest under a
range by itself.
"""
import bisect
from collections import defaultdict

import torch

from harness.probes import PREFIX

TOP = 10
NAME_CHARS = 120  # a kernel's name in the breakdown, cut (C++ templates run to kilobytes)


def _end(e) -> int:
    return e.start_ns() + e.duration_ns()


def _kind(e, cuda) -> str:
    """"kernel", "memory" (a device copy or fill), "launch" (a host CUDA
    launch call), "host" (an op or range on the host) or "other"."""
    kind = e.activity_type() if hasattr(e, "activity_type") else None
    name = e.name()
    if e.device_type() == cuda:
        if kind in ("kernel", "gpu_memcpy", "gpu_memset"):
            return "kernel" if kind == "kernel" else "memory"
        if kind is not None or name.startswith(PREFIX):
            return "other"  # a range mirrored on the device's timeline
        return "memory" if name.startswith(("Memcpy", "Memset")) else "kernel"
    if kind in ("cuda_runtime", "cuda_driver") or (
            kind is None and name.startswith("cu") and "Launch" in name):
        return "launch"
    if kind in ("cpu_op", "user_annotation") or kind is None:
        return "host"
    return "other"


def _union(intervals):
    """Total length and the gaps of a set of (start, end) intervals."""
    total, gaps, end = 0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def _innermost(starts, spans, t, lookback=64):
    """The latest-starting span of ``spans`` (sorted by start) that holds
    ``t``, looked for among the ``lookback`` spans that start last
    before it; None if none of those holds it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - lookback, -1), -1):
        if spans[j][1] >= t:
            return spans[j]
    return None


def reduce(events) -> dict:
    """Records of the window under the ``filterbench.window`` range."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges = defaultdict(list)
    launch_t, host_t = {}, {}
    host_spans, ops = [], []
    kinds = defaultdict(int)
    for e in events:
        kind = _kind(e, cuda)
        kinds[kind] += 1
        if kind in ("kernel", "memory"):
            ops.append((e, kind))
        elif kind == "launch":
            launch_t[e.correlation_id()] = e.start_ns()
        elif kind == "host":
            host_t[e.correlation_id()] = e.start_ns()
            host_spans.append((e.start_ns(), _end(e), e.name()))
            if e.name().startswith(PREFIX):
                ranges[e.name()[len(PREFIX):]].append((e.start_ns(), _end(e)))
    if len(ranges.get("window", ())) != 1:
        raise RuntimeError("the trace holds no single filterbench.window range")
    w0, w1 = ranges.pop("window")[0]
    ops = [(e, k) for e, k in ops if e.start_ns() < w1 and _end(e) > w0]
    busy, gaps = _union([(max(e.start_ns(), w0), min(_end(e), w1)) for e, _ in ops])

    per_range = {}
    sorted_ranges = {k: sorted(v) for k, v in ranges.items()}
    starts = {k: [s for s, _ in v] for k, v in sorted_ranges.items()}
    unattributed = 0
    by_name = defaultdict(int)
    for e, _ in ops:
        by_name[e.name()] += _end(e) - e.start_ns()
        t = launch_t.get(e.correlation_id(), host_t.get(e.linked_correlation_id()))
        if t is None:
            unattributed += 1
            continue
        for k, v in sorted_ranges.items():
            i = bisect.bisect_right(starts[k], t) - 1
            if i >= 0 and v[i][1] >= t:
                per_range[k] = per_range.get(k, 0) + _end(e) - e.start_ns()

    host_spans.sort()
    span_starts = [s for s, _, _ in host_spans]
    idle_by = defaultdict(int)
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:1000]:
        span = _innermost(span_starts, host_spans, (g0 + g1) // 2)
        idle_by[span[2] if span else "host between ops"] += g1 - g0

    top = lambda d: [[k[:NAME_CHARS], v / 1e9]
                     for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "kernels": sum(1 for _, k in ops if k == "kernel"),
        "device_ops": len(ops),
        "unattributed_ops": unattributed,
        "event_kinds": dict(kinds),
        "range_device_s": {k: v / 1e9 for k, v in per_range.items()},
        "range_host_s": {k: sum(e - s for s, e in v) / 1e9 for k, v in sorted_ranges.items()},
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle_by)},
    }
