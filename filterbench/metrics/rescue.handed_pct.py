"""Trials the program's rescue handed to its tiers (its
``rescue.handed.tier<k>`` counters, k >= 1), in percent of the trials
given to tier 0 (those tier 0 kept, ``rescue.kept.tier0``, and those it
handed to tier 1), read from the program's counter registry at the end
of the run: over the run's rescue calls, the traced run's two passes
over the same observations.  None where the program keeps no such
registry."""
import sys


def read(rec):
    profiling = sys.modules.get("mfs_tpu_torch.utils.profiling")
    if not hasattr(profiling, "counters") or not rec.get("has_rescue"):
        return None
    counts = profiling.counters()
    given = counts.get("rescue.kept.tier0", 0) + counts.get("rescue.handed.tier1", 0)
    if not given:
        return None
    handed = sum(v for k, v in counts.items() if k.startswith("rescue.handed."))
    return 100.0 * handed / given
