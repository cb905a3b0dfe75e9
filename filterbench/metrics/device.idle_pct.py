"""Share of the traced window in which no operation runs on the device
(the window less the union of the device operations' intervals), in
percent."""


def read(rec):
    if not rec.get("window_s") or "busy_s" not in rec or rec.get("device_ops", 0) == 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
