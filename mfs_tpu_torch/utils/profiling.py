"""Profiling helpers (port of ``mfs_tpu/utils/profiling.py``).

``timed`` is the wall-clock protocol of the JAX package: the best of
``reps`` calls, each ended by a device synchronisation (there
``block_until_ready``, here ``torch.cuda.synchronize()`` where an output
holds a CUDA tensor).  ``trace`` wraps ``torch.profiler`` and writes a
Chrome trace (``chrome://tracing``, Perfetto) where JAX writes an XProf
one.
"""
import contextlib
import os
import time
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves


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
    """``with trace(dir) as d: ...`` profiles the block's CPU ops and, where
    there is a GPU, its CUDA kernels, and writes the Chrome trace
    ``d/trace.json`` on exit.  Yields ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
