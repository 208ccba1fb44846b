"""K2, K3f/K3b and K4f/K4d/K4w together in a SAM step: the least time of
their launches at their shapes over the device time they took (their
partial-sum launches included), in %."""

from htrbench.kernels import roofline

KERNELS = ("K2", "K3f", "K3b", "K4f", "K4d", "K4w")


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t or not t.get("busy_s"):
        return None
    return roofline(KERNELS, t["plans"], t["launches"], t["kernel_s"],
                    also=("K3b/K4d partial sums",))
