"""The kernel build step on a host without a GPU: ``ops/build.py``
compiles each source once, keeps the compiler's report beside the
library, and ``chip_smoke.phase_build`` reports a library it reused as
well as one it built.  A stand-in ``nvcc`` script takes the compiler's
place."""
import importlib.util
import json
import stat
from pathlib import Path

import pytest

pytest.importorskip("torch")

from mfs_tpu_torch.ops import build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quadrature_1d", "posterior_1d", "quadrature_nd")
FAKE_NVCC = """#!/bin/sh
# writes the file after -o and prints a ptxas-style report
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; printf 'lib' > "$1"; fi
  shift
done
echo "ptxas info    : Used 40 registers, used 0 barriers"
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    calls = []

    def which():
        calls.append(1)
        return str(nvcc)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", which)
    return calls


def _build_lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_build_once_then_reuse_with_saved_report(fake_nvcc):
    logs = build.build(NAMES)
    assert sorted(logs) == sorted(NAMES) and len(fake_nvcc) == len(NAMES)
    for name in NAMES:
        assert build.library_path(name).exists()
        assert "Used 40 registers" in build.saved_log(name)
    assert build.build(NAMES) == {} and len(fake_nvcc) == len(NAMES)


def test_phase_build_reports_built_and_cached_libraries(fake_nvcc, capsys):
    smoke = _chip_smoke()
    smoke.phase_build()
    smoke.phase_build()
    first, second = _build_lines(capsys)
    assert first["phase"] == second["phase"] == "build"
    assert first["cached"] == [] and second["cached"] == list(NAMES)
    for line in (first, second):
        assert all(any("Used 40 registers" in ln for ln in line["ptxas"][n]) for n in NAMES)


def test_phase_build_with_nothing_built(monkeypatch, capsys):
    """``build.build`` returns no log for a library it did not compile."""
    smoke = _chip_smoke()
    monkeypatch.setattr(build, "build", lambda names: {})
    monkeypatch.setattr(build, "saved_log", lambda name: "")
    smoke.phase_build()
    smoke.phase_build()
    lines = _build_lines(capsys)
    assert [ln["cached"] for ln in lines] == [list(NAMES)] * 2
    assert all(ln["ptxas"] == {n: [] for n in NAMES} for ln in lines)
