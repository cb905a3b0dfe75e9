"""A tiny CPU run of each cell, through the port's plain routes, prints a
well-formed result line."""
import io
import json
import time

import pytest

from conftest import TINY

TRACE_KEYS = {"busy_s", "window_s"}


def run_cell(name, traced, seed=2**31 + 11, factory=None):
    from harness import runner
    return runner.run(name, seed, 0.05, traced, time.perf_counter(), device="cpu",
                      system_factory=factory)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", sorted(TINY))
def test_a_tiny_run_prints_a_well_formed_last_line(tiny_bench, name, traced):
    import run as entry
    from harness.cell import Cell
    result = run_cell(name, traced)
    out, err = io.StringIO(), io.StringIO()
    entry.emit(result, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True
    B = TINY[name]
    assert line["attempted"] == B * (2 if traced else len(result["records"]["finite_per_pass"]))
    assert 0 <= line["failed"] <= line["attempted"]
    cell = Cell(name)
    declared = {m["name"]: m["unit"] for m in (cell.per_layer if traced else cell.end_to_end)}
    for k, v in line["metrics"].items():
        assert declared[k] == v["unit"] and isinstance(v["value"], float)
    if not traced:
        assert set(line["metrics"]) == set(declared)  # host-clock metrics exist on a CPU too
    else:
        assert TRACE_KEYS <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    tail = err.getvalue().strip().splitlines()[-len(line["check"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)
