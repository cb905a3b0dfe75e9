"""The device memory allocated at its peak over the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), in GB."""


def read(rec):
    if not rec.get("peak_bytes"):
        return None
    return rec["peak_bytes"] / 1e9
