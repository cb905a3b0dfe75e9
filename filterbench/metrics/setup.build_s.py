"""Host seconds inside the program's ``mfs.build.*`` spans (the model
constructors and the transitions' builders: the polynomial TME's
tables, the TME closures), read from its span totals at the end of the
run.  The systems build only in set-up, so this is set-up's part.  None
where the program keeps no span totals."""
import sys


def read(rec):
    profiling = sys.modules.get("mfs_tpu_torch.utils.profiling")
    if not hasattr(profiling, "span_totals"):
        return None
    totals = profiling.span_totals()
    if not any(k.startswith("mfs.build.") for k in totals):
        return None
    return float(sum(v["host_s"] for k, v in totals.items() if k.startswith("mfs.build.")))
