"""Rows run through a forward over lines served, in the traced job: the
``rows`` of its ``serve.batch`` spans (padding rows included) and of its
``serve.calibrate`` spans (int8), over the ``lines`` of its ``serve.batch``
spans. 1 where no row is wasted. None where the program records no
spans."""

from htrbench.program_spans import traced_spans


def read(rec):
    spans = traced_spans(rec, "serve")
    batches = [s["attrs"] for s in spans if s["name"] == "serve.batch"]
    lines = sum(a["lines"] for a in batches)
    if not lines:
        return None
    calib = sum(s["attrs"]["rows"] for s in spans if s["name"] == "serve.calibrate")
    return (sum(a["rows"] for a in batches) + calib) / lines
