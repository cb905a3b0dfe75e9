"""The program's own spans and counters (``mfs_tpu_torch.utils.profiling``)
over one traced run of a cell, beside the harness's readings of the same
window.

    python3 filterbench/tools/spans.py --workload <cell> --seed <n>

Runs the cell as ``run.py --trace 1`` does (``harness.runner.run``), with
two additions of its own that the benchmark's runs do not make:

- the system's passes record the program's counters and span totals:
  ``program_counts`` and ``program_spans["window"]``, the traced pass's
  differences, and ``program_spans["setup"]``, the totals when the first
  pass starts;
- the traced window is reduced a second time, to the program's spans
  (``span_records``): ``span_device_s``, the device time of the
  operations launched inside each ``mfs.`` span, attributed by
  correlation id as ``harness/trace.py`` attributes the harness's
  ranges; ``span_idle_s``, every idle gap of the window put down to the
  innermost ``mfs.`` span that holds its midpoint, or to ``outside``;
  ``step_idle_s``, the part of the gaps inside ``mfs.step`` spans; and
  ``eigh_calls``, the ``aten::linalg_eigh`` calls in the window.

Prints one JSON line: the result's correctness and metrics, these
records, and ``readings``, the span readings a filter step beside the
harness's.  Writes nothing.
"""
import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from harness import runner, trace  # noqa: E402
from harness.probes import PREFIX  # noqa: E402

SPAN_PREFIX = "mfs."
OUTSIDE = "outside"
EIGH = "aten::linalg_eigh"


def _innermost_each(spans, points):
    """For each point of ``points`` (sorted), the innermost span of
    ``spans`` ((start, end, name), properly nested, as one thread's
    ranges are) that holds it, or None."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    stack, i, out = [], 0, []
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _overlap(intervals, a, b):
    """Length of [a, b] covered by ``intervals`` (sorted, disjoint)."""
    starts = [s for s, _ in intervals]
    total = 0
    for j in range(max(bisect.bisect_right(starts, a) - 1, 0), len(intervals)):
        s, e = intervals[j]
        if s >= b:
            break
        total += max(0, min(e, b) - max(s, a))
    return total


def program_spans(ops, launch_t, host_t, spans, w0, w1, busy_gaps):
    """``span_device_s``, ``span_idle_s`` and ``step_idle_s`` of the window
    from the program's spans ``[(start, end, name)]``: each device
    operation's time goes to every span of each name whose interval holds
    its launch; every idle gap of the window (the gaps between operations,
    and before the first and after the last) to the innermost span that
    holds its midpoint, or to ``outside``.  Without spans, or without
    device operations (a CPU run), there is nothing to read."""
    if not spans or not ops:
        return {"span_device_s": {}, "span_idle_s": None, "step_idle_s": None}
    by_name = defaultdict(list)
    for s, e, name in spans:
        by_name[name].append((s, e))
    by_name = {k: sorted(v) for k, v in by_name.items()}
    starts = {k: [s for s, _ in v] for k, v in by_name.items()}
    device = defaultdict(int)
    for e, _ in ops:
        t = launch_t.get(e.correlation_id(), host_t.get(e.linked_correlation_id()))
        if t is None:
            continue
        for k, v in by_name.items():
            i = bisect.bisect_right(starts[k], t) - 1
            if i >= 0 and v[i][1] >= t:
                device[k] += trace._end(e) - e.start_ns()
    edges = [(max(e.start_ns(), w0), min(trace._end(e), w1)) for e, _ in ops]
    first, last = min(a for a, _ in edges), max(b for _, b in edges)
    gaps = [(w0, first)] * (first > w0) + list(busy_gaps) + [(last, w1)] * (w1 > last)
    gaps.sort(key=lambda g: (g[0] + g[1]) // 2)
    idle = defaultdict(int)
    for (g0, g1), span in zip(gaps, _innermost_each(spans, [(g0 + g1) // 2 for g0, g1 in gaps])):
        idle[span[2] if span else OUTSIDE] += g1 - g0
    steps = by_name.get(SPAN_PREFIX + "step", [])
    step_idle = sum(_overlap(steps, g0, g1) for g0, g1 in gaps)
    return {"span_device_s": {k: v / 1e9 for k, v in device.items()},
            "span_idle_s": {k: v / 1e9 for k, v in idle.items()},
            "step_idle_s": step_idle / 1e9}


def span_records(events) -> dict:
    """The program's spans in the window under the ``filterbench.window``
    range, events classed as ``harness/trace.py`` classes them."""
    cuda = torch.autograd.DeviceType.CUDA
    launch_t, host_t, ops, spans, window = {}, {}, [], [], []
    eigh = []
    for e in events:
        kind = trace._kind(e, cuda)
        if kind in ("kernel", "memory"):
            ops.append((e, kind))
        elif kind == "launch":
            launch_t[e.correlation_id()] = e.start_ns()
        elif kind == "host":
            host_t[e.correlation_id()] = e.start_ns()
            name = e.name()
            if name == PREFIX + "window":
                window.append((e.start_ns(), trace._end(e)))
            elif name.startswith(SPAN_PREFIX):
                spans.append((e.start_ns(), trace._end(e), name))
            elif name == EIGH:
                eigh.append(e.start_ns())
    (w0, w1), = window
    ops = [(e, k) for e, k in ops if e.start_ns() < w1 and trace._end(e) > w0]
    _, gaps = trace._union([(max(e.start_ns(), w0), min(trace._end(e), w1)) for e, _ in ops])
    return {**program_spans(ops, launch_t, host_t, spans, w0, w1, gaps),
            "eigh_calls": sum(w0 <= t <= w1 for t in eigh)}


def difference(after: dict, before: dict) -> dict:
    """``after`` less ``before``, key by key, for counts or span totals;
    keys that did not move are left out."""
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            was = before.get(k, {})
            d = {f: x - was.get(f, 0) for f, x in v.items()}
            if any(d.values()):
                out[k] = d
        elif v != before.get(k, 0):
            out[k] = v - before.get(k, 0)
    return out


class Recorded:
    """A cell's system whose passes record the program's counters and span
    totals (``profiling``): ``setup``, the span totals at the first pass's
    start, and ``last``, the counts and span totals of the latest pass."""

    def __init__(self, system, profiling):
        self._system, self._profiling = system, profiling
        self.setup = self.last = None

    def __getattr__(self, name):
        return getattr(self._system, name)

    def run_pass(self, ys):
        p = self._profiling
        if self.setup is None:
            self.setup = p.span_totals()
        counts, spans = p.counters(), p.span_totals()
        out = self._system.run_pass(ys)
        self.last = (difference(p.counters(), counts), difference(p.span_totals(), spans))
        return out


def readings(rec: dict) -> dict:
    """Milliseconds a filter step under each span beside the harness's
    ranges, and the shares the spans' attribution is checked by."""
    steps = rec["program_counts"].get("filter.steps", 0)
    dev = rec["span_device_s"]
    if not steps or not dev:
        return {}
    ms = lambda t: None if t is None else 1e3 * t / steps
    step = dev.get("mfs.step", 0)
    inside = sum(dev.get(SPAN_PREFIX + k, 0) for k in ("transition", "quadrature", "update"))
    filt = dev.get("mfs.filter", 0)
    return {
        "transition.span_ms_per_step": ms(dev.get("mfs.transition")),
        "quadrature.span_ms_per_step": ms(dev.get("mfs.quadrature")),
        "update.span_ms_per_step": ms(dev.get("mfs.update")),
        "loop.wait_ms_per_step": ms(rec["step_idle_s"]),
        "loop.syncs_per_step.window": sum(
            v for k, v in rec["program_counts"].items() if k.startswith("sync.")) / steps,
        "eigh_calls_per_step": rec["eigh_calls"] / steps,
        "transition.range_ms_per_step": ms(rec["range_device_s"].get("transition")),
        "quadrature.range_ms_per_step": ms(rec["range_device_s"].get("quadrature")),
        "step_share_in_spans": inside / step if step else None,
        "filter_share_of_busy": filt / rec["busy_s"] if rec["busy_s"] else None,
        "filter_steps": rec["counts"].get("filter_steps"),
        "program_filter_steps": steps,
    }


def run(workload: str, seed: int, device: str = "cuda", system_factory=None) -> dict:
    """One traced run of ``workload`` with the program's records added;
    ``system_factory`` as ``runner.run`` takes it."""
    from mfs_tpu_torch.utils import profiling
    made = []

    def factory(cell, dev, probes):
        system = (system_factory(cell, dev, probes) if system_factory is not None else
                  cell.module("systems").System(cell.config, cell.traffic, dev, probes))
        made.append(Recorded(system, profiling))
        return made[-1]

    reduce = trace.reduce

    def both(events):
        events = list(events)
        return {**reduce(events), **span_records(events)}

    trace.reduce = both
    try:
        result = runner.run(workload, seed, 0.0, True, time.perf_counter(), device=device,
                            system_factory=factory)
    finally:
        trace.reduce = reduce
    rec = result["records"]
    rec["program_counts"], window = made[0].last
    rec["program_spans"] = {"setup": made[0].setup, "window": window}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    result = run(args.workload, args.seed)
    rec = result["records"]
    keep = ("program_counts", "program_spans", "span_device_s", "span_idle_s", "step_idle_s",
            "eigh_calls", "busy_s", "window_s", "range_device_s", "counts", "rerun", "B")
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": result["correct"], "metrics": result["metrics"],
                      "readings": readings(rec), "records": {k: rec.get(k) for k in keep}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
