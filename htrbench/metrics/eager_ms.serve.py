"""Device ms an eval batch in the eager elementwise kernels and the dtype
casts and copies (``trace.EAGER``; the folded epilogues, and under int8
the s8 passes), over the traced job's batches."""

from htrbench.trace import EAGER


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "serve" or not t or not t.get("busy_s"):
        return None
    return 1e3 * sum(t["category_s"].get(c, 0.0) for c in EAGER) / t["units"]
