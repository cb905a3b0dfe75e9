"""The quadrature function's least time at the H100's published peaks
(``roofline/work.py``: the larger of its operations over the FP64
tensor-core rate and its bytes over the HBM bandwidth, summed over the
calls of the traced window), over the device time under the quadrature
range, in percent."""
from roofline.work import least_seconds


def read(rec):
    t = rec.get("range_device_s", {}).get("quadrature")
    work = rec.get("work")
    if not t or not work or not work["flops"]:
        return None
    return 100.0 * least_seconds(work) / t
