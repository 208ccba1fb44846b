"""Share of the window's time in which no kernel ran on the device, in %:
one minus the device's busy seconds a SAM step in the traced stretch over the
seconds a SAM step took in the untraced window. The profiler's own host work
slows the traced stretch, so its idle share is not the window's."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["stretch_units"] / rec["unit_s"])
