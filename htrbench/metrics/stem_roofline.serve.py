"""K3f and K4f together in serving: the least time of their launches at
their shapes over the device time they took, in %."""

from htrbench.kernels import roofline


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "serve" or not t or not t.get("busy_s"):
        return None
    return roofline(("K3f", "K4f"), t["plans"], t["launches"], t["kernel_s"])
