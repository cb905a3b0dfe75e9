"""Trial-steps filtered per second: over the window's passes, the trials
finite at the end of each pass times T, over the host-clock time from
the window's start to the end of its last pass."""


def read(rec):
    if "finite_per_pass" not in rec or rec.get("window_s", 0) <= 0 or "busy_s" in rec:
        return None
    return sum(rec["finite_per_pass"]) * rec["T"] / rec["window_s"]
