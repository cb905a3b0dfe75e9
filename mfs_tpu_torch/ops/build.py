"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``mfs_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on first use into ``build/kernels/<name>-<hash>.so`` at the
repository root, keyed by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one is reused.  The compiler's
output is kept beside it as ``<name>-<hash>.log``.  Nothing here runs at
import time.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

from mfs_tpu_torch.utils.profiling import span

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


def saved_log(name: str) -> str:
    """The compiler's output from the build of the current ``name``
    library, or "" if it was built without one."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@span("mfs.kernels.build")
def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet: one
    ``nvcc`` per source, all started together.  Returns the compiler's
    output (``-Xptxas -v``: registers, stack, spills) per source it
    built, and raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in dict.fromkeys(names):
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
@span("mfs.kernels.load")
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
