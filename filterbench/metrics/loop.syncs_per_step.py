"""Places where the program blocked the host on the device (its
``sync.<site>`` counters) over its filter steps (``filter.steps``), both
read from the program's counter registry at the end of the run: over
the run's one process, set-up's warm-up and both passes of the traced
run included.  None where the program keeps no such registry."""
import sys


def read(rec):
    profiling = sys.modules.get("mfs_tpu_torch.utils.profiling")
    if not hasattr(profiling, "counters"):
        return None
    counts = profiling.counters()
    if not counts.get("filter.steps"):
        return None
    syncs = sum(v for k, v in counts.items() if k.startswith("sync."))
    return float(syncs) / counts["filter.steps"]
