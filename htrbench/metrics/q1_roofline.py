"""Q1, the int8 stem conv, with its quantize kernel: the least time of its
launches at their shapes (at the int8 peak) over the device time they
took, in %."""

from htrbench.kernels import roofline


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "serve" or not t or not t.get("busy_s"):
        return None
    return roofline(("Q1",), t["plans"], t["launches"], t["kernel_s"])
