"""Device milliseconds a filter step of the operations launched inside the
harness's range around the filter loop's quadrature (two calls a step)."""


def read(rec):
    steps = rec.get("counts", {}).get("filter_steps", 0)
    t = rec.get("range_device_s", {}).get("quadrature")
    if not steps or not t:
        return None
    return 1e3 * t / steps
