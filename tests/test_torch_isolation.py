"""The port stands alone: nothing under ``mfs_tpu_torch/`` and nothing in
``chip_smoke.py`` imports ``jax`` or the JAX package ``mfs_tpu`` (the
module itself or its submodules; ``mfs_tpu_torch`` is not matched)."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "mfs_tpu", "jaxlib")


def _port_files():
    files = sorted((ROOT / "mfs_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_neither_jax_nor_mfs_tpu():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert not bad, bad


def test_forbidden_matcher():
    assert _forbidden("mfs_tpu") and _forbidden("mfs_tpu.ops.eigh") and _forbidden("jax.numpy")
    assert not _forbidden("mfs_tpu_torch") and not _forbidden("mfs_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like")
