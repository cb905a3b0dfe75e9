"""Nothing of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the port.  Top-level module names are
compared whole: the port's name, ``mfs_tpu_torch``, begins with the JAX
package's."""
import ast
import subprocess
import sys

import pytest

from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "mfs_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names.add("<dynamic>")
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    found = top_level_imports(path)
    assert not found & FORBIDDEN, found
    assert "<dynamic>" not in found


def test_the_comparison_is_by_whole_names():
    from harness.runner import forbidden_modules
    assert "mfs_tpu_torch".split(".")[0] not in FORBIDDEN
    before = set(sys.modules)
    assert forbidden_modules() == sorted({m.split(".")[0] for m in before} & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    found = top_level_imports(path)
    assert "mfs_tpu_torch" not in found
    assert found <= {"torch", "math", "numpy", "reference"}, found


def test_a_cpu_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process leaves no forbidden module loaded."""
    from conftest import copy_benchmark
    bench = copy_benchmark(tmp_path)
    (tmp_path / "mfs_tpu_torch").symlink_to(REPO / "mfs_tpu_torch")
    code = (
        "import sys, time; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from harness import runner\n"
        "r = runner.run('pp.n3.b262144', 7, 0.1, False, time.perf_counter(), device='cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(runner.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(bench), str(tmp_path)],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    loaded, forbidden = out.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert "'mfs_tpu_torch'" in loaded and "'mfs_tpu'" not in loaded
