"""Cells, configurations and metrics are found by name, so that a later
change adds them as files and entries only."""
import json
import textwrap
import time

import pytest

from conftest import BENCH, REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(name):
    from harness.cell import Cell, load_module
    cell = Cell(name)
    assert cell.config["name"] == cell.entry["config"]
    for kind in ("systems", "traffic", "reference"):
        assert cell.module(kind).__file__.startswith(str(BENCH / kind))
    for m in cell.end_to_end + cell.per_layer:
        assert callable(load_module("metrics", m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "trial_steps_per_s"}


def test_a_cell_and_a_metric_added_as_files_only_are_picked_up(tiny_bench):
    """A new traffic mix of an existing configuration, and a new per-layer
    metric, added as a workload file, a metric reader and two entries of
    BENCHMARK.json, run without a change to any file already there."""
    from harness import runner
    spec_path = tiny_bench.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": "pp.n2.b24", "config": "prey_predator",
                              "traffic": "n2.b24", "chips": 1, "why": "added as data"})
    spec["per_layer"].append({"name": "loop.steps_traced", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "filter loops",
                              "moves": "trial_steps_per_s", "workloads": ["pp.n2.b24"]})
    spec_path.write_text(json.dumps(spec))
    template = json.loads((tiny_bench / "workloads" / "pp.n3.b262144.json").read_text())
    template.update(traffic={"N": 2, "B": 24})
    (tiny_bench / "workloads" / "pp.n2.b24.json").write_text(json.dumps(template))
    (tiny_bench / "metrics" / "loop.steps_traced.py").write_text(
        "def read(rec):\n    return float(rec['counts']['filter_steps'])\n")
    result = runner.run("pp.n2.b24", 5, 0.05, True, time.perf_counter(), device="cpu")
    assert result["correct"] is True
    assert result["metrics"]["loop.steps_traced"]["value"] == 20.0
    untraced = runner.run("pp.n2.b24", 5, 0.05, False, time.perf_counter(), device="cpu")
    assert "loop.steps_traced" not in untraced["metrics"]
    other = runner.run("pp.n3.b262144", 5, 0.05, True, time.perf_counter(), device="cpu")
    assert "loop.steps_traced" not in other["metrics"]


# A configuration whose answers and compared numbers differ from the
# filters': a scalar Gaussian random walk observed in noise, whose system
# and reference are both a Kalman filter, judged by the log likelihood.
NEW_CONFIG = {"name": "random_walk", "system": "random_walk", "source": "a test's own model",
              "model": {"q": 0.1, "r": 0.5, "T": 20}, "reduced": []}
NEW_FILES = {
    "traffic": """
        import torch

        def generate(model, traffic, gen):
            T, B = model["T"], traffic["B"]
            noise = torch.randn((2, T, B), generator=gen, dtype=torch.float64,
                                device=gen.device)
            x = (model["q"] ** 0.5 * noise[0]).cumsum(0)
            return {"ys": x + model["r"] ** 0.5 * noise[1]}
    """,
    "reference": """
        import math

        import torch

        ANSWERS = ("loglik", "finite")
        NUMBERS = ("loglik_gap",)
        CONTROLS = {"float32": {"dtype": torch.float32}}

        def run(config, traffic, ys, dtype):
            model = config["model"]
            ys = ys.to(dtype)
            m, P = torch.zeros_like(ys[0]), torch.zeros_like(ys[0])
            ll = torch.zeros_like(ys[0])
            for y in ys:
                P = P + model["q"]
                S = P + model["r"]
                ll = ll - 0.5 * (math.log(2 * math.pi) + S.log() + (y - m) ** 2 / S)
                m, P = m + P / S * (y - m), P - P * P / S
            return {"loglik": ll, "finite": torch.isfinite(ll)}

        def numbers(program, reference):
            gap = (program["loglik"] - reference["loglik"].double()).abs()
            return {"loglik_gap": gap.max().item()}
    """,
    "systems": """
        import torch

        class System:
            def __init__(self, config, traffic, device, probes):
                self.model = config["model"]

            def run_pass(self, ys):
                m, P = torch.zeros_like(ys[0]), torch.zeros_like(ys[0])
                ll = torch.zeros_like(ys[0])
                for y in ys:
                    P = P + self.model["q"]
                    S = P + self.model["r"]
                    ll = ll - 0.5 * (torch.log(2 * torch.pi * S) + (y - m) ** 2 / S)
                    m, P = m + P / S * (y - m), P - P * P / S
                return {"loglik": ll, "finite": torch.isfinite(ll)}

            def warm_up(self, ys, steps):
                self.run_pass(ys[:steps])
    """,
}


def test_a_configuration_added_as_files_only_is_picked_up(tiny_bench):
    """A new configuration, with answers and compared numbers of its own,
    added as its configuration, system, traffic, reference and workload
    files and two entries of BENCHMARK.json, runs and is judged by its own
    numbers without a change to any file already there."""
    from harness import runner
    spec_path = tiny_bench.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "random_walk", "source": "a test's own model",
                            "file": "filterbench/configs/random_walk.json", "reduced": [],
                            "why": "added as data"})
    spec["workloads"].append({"name": "rw.b64", "config": "random_walk", "traffic": "b64",
                              "chips": 1, "why": "added as data"})
    spec_path.write_text(json.dumps(spec))
    (tiny_bench / "configs" / "random_walk.json").write_text(json.dumps(NEW_CONFIG))
    for kind, text in NEW_FILES.items():
        (tiny_bench / kind / "random_walk.py").write_text(textwrap.dedent(text))
    (tiny_bench / "workloads" / "rw.b64.json").write_text(json.dumps(
        {"traffic": {"B": 64}, "check": {"sample": 16}, "limits": {"loglik_gap": 1e-9}}))
    result = runner.run("rw.b64", 7, 0.05, False, time.perf_counter(), device="cpu")
    assert result["correct"] is True and list(result["check"]) == ["loglik_gap"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "trial_steps_per_s"}
    traced = runner.run("rw.b64", 7, 0.05, True, time.perf_counter(), device="cpu")
    assert traced["correct"] is True and "busy_s" in traced["device"]


def test_an_unknown_cell_is_refused():
    from harness.cell import Cell
    with pytest.raises(FileNotFoundError):
        Cell("no.such.cell")
