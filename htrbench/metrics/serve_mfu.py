"""The serving step's share of the card's peaks: the least time of the
forwards of the lines served in the window, each operation at the peak of
the type the configuration computes it in (``flops.serve_peak_seconds``),
over the window's time. Padding rows are not lines served."""


def read(rec):
    if rec.get("kind") != "serve" or rec["window_s"] <= 0:
        return None
    return 100.0 * rec["peak_seconds"] / rec["window_s"]
