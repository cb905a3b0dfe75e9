"""The program's own spans and counters (``mfs_tpu_torch.utils.profiling``)
in a traced run: recorded by ``tools/spans.py`` over the window, equal
to the harness's own counts; read by the three metrics that read the
program's registry at the end of a run; and absent, with every existing
metric as before, where the program has none (as before the program had
spans)."""
import importlib.util
import json
import time

import pytest

from conftest import BENCH, TINY

NEW_METRICS = {"loop.syncs_per_step", "rescue.handed_pct", "setup.build_s"}
SEED = 2**31 + 23


def _spans_tool():
    spec = importlib.util.spec_from_file_location("filterbench_tools_spans",
                                                  BENCH / "tools" / "spans.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def fresh_program(monkeypatch):
    """The program's counters and span totals from zero, as in a run's own
    process."""
    from mfs_tpu_torch.utils import profiling
    profiling.reset_counters()
    monkeypatch.setattr(profiling, "_SPANS", {})
    return profiling


def traced_run(name, factory=None):
    from harness import runner
    return runner.run(name, SEED, 0.05, True, time.perf_counter(), device="cpu",
                      system_factory=factory)


@pytest.mark.parametrize("name", ["bb.n15.b524288", "pp.n3.b262144"])
def test_a_traced_run_records_the_programs_counts_and_spans(tiny_bench, name):
    result = _spans_tool().run(name, SEED, device="cpu")
    rec = result["records"]
    assert result["correct"] is True
    counts, spans = rec["program_counts"], rec["program_spans"]
    assert counts["filter.steps"] == rec["counts"]["filter_steps"] == rec["T"]
    assert counts["quadrature.calls.refined"] == 2 * rec["T"]
    assert counts["quadrature.trials.refined"] == 2 * rec["T"] * TINY[name]
    assert spans["window"]["mfs.step"]["calls"] == rec["T"]
    assert spans["window"]["mfs.filter"]["calls"] == 1
    assert spans["setup"]["mfs.build.model"]["calls"] >= 1
    assert spans["setup"]["mfs.build.transition"]["calls"] >= 1
    assert "mfs.build.model" not in spans["window"]
    assert rec["span_device_s"] == {} and rec["step_idle_s"] is None  # no device on a CPU
    json.dumps(spans)


def test_the_rescue_counters_equal_the_harness_count(small_sample, fresh_program):
    from test_rescue import NAME, factory, lost_by_tier0
    result = _spans_tool().run(NAME, SEED, device="cpu", system_factory=factory())
    rec = result["records"]
    handed = int(lost_by_tier0(small_sample).sum())
    assert rec["program_counts"]["rescue.handed.tier1"] == handed == rec["rerun"]
    assert rec["program_counts"]["rescue.kept.tier1"] == handed
    assert rec["program_counts"]["filter.steps"] == rec["counts"]["filter_steps"]
    m = result["metrics"]
    assert m["rescue.handed_pct"]["value"] == m["rescue.rerun_pct"]["value"] > 0


@pytest.fixture
def small_sample(tiny_bench):
    path = tiny_bench / "workloads" / "bb.n15.b524288.json"
    w = json.loads(path.read_text())
    w["check"]["sample"] = 8
    path.write_text(json.dumps(w))
    return w["traffic"]["B"]


@pytest.mark.parametrize("name", ["bb.n15.b524288", "pp.n3.b262144"])
def test_the_new_metrics_read_the_program_and_none_without_it(tiny_bench, monkeypatch,
                                                              fresh_program, name):
    seen = traced_run(name)
    setup_builds = sum(v["host_s"] for k, v in fresh_program.span_totals().items()
                       if k.startswith("mfs.build."))
    monkeypatch.delattr(fresh_program, "counters")
    monkeypatch.delattr(fresh_program, "span_totals")
    hidden = traced_run(name)
    assert hidden["correct"] is True
    assert not NEW_METRICS & set(hidden["metrics"])
    old = {k: v for k, v in seen["metrics"].items() if k not in NEW_METRICS}
    assert set(hidden["metrics"]) == set(old)
    for k in ("rescue.rerun_pct", "loop.kernels_per_step"):
        assert hidden["metrics"].get(k) == old.get(k)
    read = {"loop.syncs_per_step", "setup.build_s"} | (
        {"rescue.handed_pct"} if name.startswith("bb.") else set())
    assert NEW_METRICS & set(seen["metrics"]) == read
    assert seen["metrics"]["loop.syncs_per_step"]["value"] == 0.0  # CPU tensors: no waits
    assert seen["metrics"]["setup.build_s"]["value"] == setup_builds > 0


def test_the_builds_are_set_ups_part(tiny_bench, fresh_program):
    """The systems build only before their first pass, so the build spans'
    totals at the end of a run are set-up's."""
    result = _spans_tool().run("pp.n3.b262144", SEED, device="cpu")
    spans = result["records"]["program_spans"]
    builds = {k: v for k, v in fresh_program.span_totals().items() if k.startswith("mfs.build.")}
    assert builds == {k: v for k, v in spans["setup"].items() if k.startswith("mfs.build.")}
    assert result["metrics"]["setup.build_s"]["value"] == sum(v["host_s"] for v in builds.values())


class _Op:
    """A device operation as the profiler gives it: its interval and the
    correlation id of the host call that launched it."""

    def __init__(self, start, end, cid):
        self.start, self.end, self.cid = start, end, cid

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def correlation_id(self):
        return self.cid

    def linked_correlation_id(self):
        return 0


def test_program_spans_attribute_device_time_and_every_idle_gap():
    """A window [0, 140] with one step [10, 90] holding a quadrature
    [10, 40] (launching at 12 and 35) and an update [41, 88] (launching
    at 45): the device time goes to the span of each name that holds the
    launch; the idle gaps (0-20, 30-50, 60-140) go to the innermost span
    holding their midpoints (10, 40: the quadrature), or outside (100),
    and add up to the window less the busy time; the step holds
    10 + 20 + 30 of them."""
    tool = _spans_tool()
    OUTSIDE, program_spans = tool.OUTSIDE, tool.program_spans
    spans = [(10, 90, "mfs.step"), (10, 40, "mfs.quadrature"), (41, 88, "mfs.update")]
    ops = [(_Op(20, 30, 1), "kernel"), (_Op(50, 60, 2), "kernel"), (_Op(55, 58, 3), "kernel")]
    launch = {1: 12, 2: 35, 3: 45}
    got = program_spans(ops, launch, {}, spans, 0, 140, [(30, 50)])
    assert got["span_device_s"] == pytest.approx({"mfs.step": 23e-9, "mfs.quadrature": 20e-9,
                                                  "mfs.update": 3e-9})
    assert got["span_idle_s"] == pytest.approx({"mfs.quadrature": 40e-9, OUTSIDE: 80e-9})
    assert sum(got["span_idle_s"].values()) == pytest.approx((140 - 20) * 1e-9)
    assert got["step_idle_s"] == pytest.approx((10 + 20 + 30) * 1e-9)
    none = program_spans(ops, launch, {}, [], 0, 140, [(30, 50)])
    assert none == {"span_device_s": {}, "span_idle_s": None, "step_idle_s": None}
