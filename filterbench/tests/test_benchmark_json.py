"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names,
units and sizes, and the files it names."""
import json
import re

import pytest

from conftest import BENCH, REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "filterbench/run.py"]
    assert SPEC["paths"] == ["filterbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = ([c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        listed = [x["name"] for x in SPEC[group]]
        assert len(listed) == len(set(listed)), group
    for text in ([c["why"] for c in SPEC["configs"] + SPEC["workloads"]]
                 + [c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_entries_have_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    moves = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in moves
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_named_files_exist():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        path = REPO / c["file"]
        assert path.parent == BENCH / "configs" and path.is_file()
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for kind in ("systems", "traffic", "reference"):
            assert (BENCH / kind / f"{cfg['system']}.py").is_file()
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for name in cells:
        assert (BENCH / "workloads" / f"{name}.json").is_file(), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert set(m.get("workloads", cells)) <= set(cells)


def test_a_full_check_of_24_cells_fits_its_time_budget():
    cells = 24  # the most cells a benchmark may hold, each run at this length
    runs = 2 + 14 * cells
    total = runs * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_compares_some_numbers_each_with_a_limit(name):
    from harness.cell import Cell
    cell = Cell(name)
    local = cell.workload
    assert local["limits"] and set(local["limits"]) <= set(cell.module("reference").NUMBERS)
    assert all(0 <= v < 1 for v in local["limits"].values())
