"""Device ms a SAM step in the eager elementwise kernels and the dtype
casts and copies (``trace.EAGER``), over the traced steps."""

from htrbench.trace import EAGER


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t or not t.get("busy_s"):
        return None
    return 1e3 * sum(t["category_s"].get(c, 0.0) for c in EAGER) / t["units"]
