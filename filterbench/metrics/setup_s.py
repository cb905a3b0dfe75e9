"""Seconds from the process's start to the window's start: imports, the
CUDA context, the kernels loaded or built, the observations sampled, the
filter built and the cell's shapes warmed up."""


def read(rec):
    return rec.get("setup_s")
