"""The check catches a broken timed path: a run that skips the look for a
chip, with a fault planted under the system, comes out not correct, and
the same run without the fault comes out correct.

Faults a one-chip filter cell can have: a step that returns its state
unchanged (here every step after the first); half of the batch left out,
either given the other half's answers or returned as NaN, and every
trial but one returned as NaN; and an answer altered where it is
produced (every trial's nell off by one part in 10^5).  No cell spans
chips, so no exchange between chips can be left out."""
import time

import pytest
import torch

from conftest import TINY


class Faulty:
    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault
        self.quadrature_site = inner.quadrature_site

    def warm_up(self, ys, steps):
        self.inner.warm_up(ys, steps)

    def run_pass(self, ys):
        if self.fault == "stale":
            return self.inner.run_pass(ys[:1])
        if self.fault == "half":
            half = ys.shape[1] // 2
            out = self.inner.run_pass(ys[:, :half])
            fill = torch.arange(ys.shape[1], device=ys.device) % half
            return {k: (v[fill] if torch.is_tensor(v) else v) for k, v in out.items()}
        out = self.inner.run_pass(ys)
        if self.fault in ("nan_half", "nan_but_one"):
            trial = torch.arange(ys.shape[1], device=ys.device)
            lost = trial % 2 == 1 if self.fault == "nan_half" else trial > 0
            nan = lambda v: torch.where(lost.view((-1,) + (1,) * (v.dim() - 1)), torch.nan, v)
            return dict(out, nell=nan(out["nell"]), mean=nan(out["mean"]),
                        finite=out["finite"] & ~lost)
        return dict(out, nell=out["nell"] * (1 + 1e-5))


def run(name, fault=None):
    from harness import runner

    def factory(cell, device, probes):
        inner = cell.module("systems").System(cell.config, cell.traffic, device, probes)
        return inner if fault is None else Faulty(inner, fault)
    return runner.run(name, 2**31 + 3, 0.05, False, time.perf_counter(), device="cpu",
                      system_factory=factory)


@pytest.mark.parametrize("fault", [None, "stale", "half", "nan_half", "nan_but_one",
                                   "altered"])
@pytest.mark.parametrize("name", sorted(TINY))
def test_a_planted_fault_is_not_correct(tiny_bench, name, fault):
    result = run(name, fault)
    assert result["correct"] is (fault is None), result["check"]
