"""Profiling helpers (port of ``mfs_tpu/utils/profiling.py``), and the
program's own spans and counters.

``timed`` is the wall-clock protocol of the JAX package: the best of
``reps`` calls, each ended by a device synchronisation (there
``block_until_ready``, here ``torch.cuda.synchronize()`` where an output
holds a CUDA tensor).  ``trace`` wraps ``torch.profiler`` and writes a
Chrome trace (``chrome://tracing``, Perfetto) where JAX writes an XProf
one; the trace shows the program's ``mfs.`` spans.

Spans (``span``) name the program's layers: the filter call, each step,
its transition, quadratures and Bayes update, each hand-written kernel's
launch, each cuSOLVER ``eigh``, the rescue's tiers, and the set-up's
builds.  While a ``torch.profiler`` profile is active a span is a host
range on the profiler's own timeline, so every device operation and idle
gap can be put down to the innermost span around its launch.  The range
is an op's (``_RecordFunctionFast``), not a ``record_function`` user
annotation: the profiler mirrors a user annotation onto the device's
timeline as an event of its own, which a reader of the trace would take
for device work.  Every span, profiled or not, also adds its host
duration (``time.perf_counter_ns``) and one call to ``span_totals()``.

Counters (``count``, ``counters``, ``reset_counters``) are always on and
count only what the host already knows: filter steps, quadrature calls
and trials by route, kernel launches, ``eigh`` calls and matrices that
did not converge, the rescue's trials, and the places where the program
blocks the host on the device (``sync.<site>``).
"""
import contextlib
import functools
import os
import time
from typing import Callable, Dict

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._pytree import tree_leaves

_COUNTS: Dict[str, int] = {}
_SPANS: Dict[str, list] = {}  # name -> [calls, host nanoseconds]


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A snapshot of every counter: ``{name: count}``."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


def span_totals() -> Dict[str, Dict[str, float]]:
    """A snapshot of every span's totals since import:
    ``{name: {"calls": n, "host_s": seconds}}``, host time from entry to
    exit, nested spans' time included in their parent's."""
    return {k: {"calls": c, "host_s": ns / 1e9} for k, (c, ns) in _SPANS.items()}


class span:
    """``with span("mfs.step"): ...`` or, as a decorator, ``@span(name)``:
    one call of a named program span (see the module's docstring)."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        total = _SPANS.get(self.name)
        if total is None:
            _SPANS[self.name] = [1, dt]
        else:
            total[0] += 1
            total[1] += dt
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


def _synchronize(out) -> None:
    devices = {x.device for x in tree_leaves(out) if torch.is_tensor(x) and x.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def timed(fn: Callable, *args, reps: int = 3, warmup: bool = True):
    """(best wall time in seconds, last outputs) of ``fn(*args)``."""
    if warmup:
        _synchronize(fn(*args))
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _synchronize(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def trace(log_dir: str = "mfs_tpu_torch_trace"):
    """``with trace(dir) as d: ...`` profiles the block's CPU ops, the
    program's ``mfs.`` spans and, where there is a GPU, its CUDA kernels,
    and writes the Chrome trace ``d/trace.json`` on exit.  Yields
    ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
