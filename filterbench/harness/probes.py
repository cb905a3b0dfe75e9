"""What the harness puts around the calls into the program: counters,
always on, and profiler ranges, on only while a traced window runs.

Ranges are ``torch.profiler.record_function`` spans named
``filterbench.<layer>``: around the transition callables the harness
hands the filter, and around the module-level quadrature the filter loop
calls (patched in for the traced window only, and put back after it).
"""
import contextlib

import torch

PREFIX = "filterbench."


class Probes:
    def __init__(self):
        self.tracing = False
        self.counts = {}
        self.work = {"flops": 0, "bytes": 0}

    def count(self, name: str, n: int) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def transition(self, fn):
        """``fn`` inside a ``filterbench.transition`` range while tracing."""
        def wrapped(*args, **kwargs):
            if not self.tracing:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(PREFIX + "transition"):
                return fn(*args, **kwargs)
        return wrapped

    @contextlib.contextmanager
    def traced(self, quadrature_site):
        """Counters from zero, ranges on, and the quadrature at
        ``quadrature_site = (module, attribute, work_fn)`` inside a
        ``filterbench.quadrature`` range that adds ``work_fn``'s
        operations and bytes of each call.  A system with no quadrature
        gives ``None``."""
        self.counts = {}
        self.work = {"flops": 0, "bytes": 0}
        module, attr, work_fn = quadrature_site or (None, None, None)
        original = getattr(module, attr) if module is not None else None

        def quadrature(*args, **kwargs):
            w = work_fn(*args, **kwargs)
            self.work["flops"] += w["flops"]
            self.work["bytes"] += w["bytes"]
            with torch.profiler.record_function(PREFIX + "quadrature"):
                return original(*args, **kwargs)

        if module is not None:
            setattr(module, attr, quadrature)
        self.tracing = True
        try:
            yield self
        finally:
            self.tracing = False
            if module is not None:
                setattr(module, attr, original)
