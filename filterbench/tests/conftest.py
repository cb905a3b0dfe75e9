"""Helpers of the harness's own tests: the harness's import path and a
temporary copy of the benchmark whose cells are cut to CPU size."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(2)

# Each real cell cut to a CPU size: its N, few trials (the sample all of
# them) and T = 20 steps, on the port's plain PyTorch routes ("auto" on a
# CPU tensor).
TINY = {"bb.n15.b524288": 48, "pp.n7.b8192": 6, "pp.n3.b262144": 32}
TINY_T = 20


def copy_benchmark(dest: Path, tiny: bool = True) -> Path:
    """A copy of ``BENCHMARK.json`` and the harness under ``dest``; with
    ``tiny`` every cell's batch is cut to ``TINY`` and every model's
    horizon to ``TINY_T``."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "filterbench", ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    if tiny:
        for cell, B in TINY.items():
            path = dest / "filterbench" / "workloads" / f"{cell}.json"
            w = json.loads(path.read_text())
            w["traffic"]["B"] = B
            w["check"]["sample"] = B
            path.write_text(json.dumps(w))
        for path in (dest / "filterbench" / "configs").glob("*.json"):
            c = json.loads(path.read_text())
            c["model"]["T"] = TINY_T
            path.write_text(json.dumps(c))
    return dest / "filterbench"


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """The harness of a tiny copy, imported from there."""
    bench = copy_benchmark(tmp_path)
    from harness import cell as cell_mod
    monkeypatch.setattr(cell_mod, "ROOT", bench)
    monkeypatch.setattr(cell_mod, "BENCHMARK", bench.parent / "BENCHMARK.json")
    return bench
