"""Device kernels in the traced window over the filter steps in it (every
filter call counts its T steps, rescue tiers included)."""


def read(rec):
    steps = rec.get("counts", {}).get("filter_steps", 0)
    if not steps or not rec.get("kernels"):
        return None
    return rec["kernels"] / steps
