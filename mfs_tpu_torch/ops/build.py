"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``mfs_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on first use into ``build/kernels/<name>-<hash>.so`` at the
repository root, keyed by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one is reused.  Nothing here
runs at import time.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a CUDA host")
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source.  Returns the compiler's output (``-Xptxas -v``:
    registers, spills) per source it built, and raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs[name] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        os.replace(tmp, out)
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
