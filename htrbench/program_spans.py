"""What the readers of ``source`` ``program_span`` share: the program's
spans of a traced run (``htr_vt_torch/utils/logging.py:spans``), and the
host ms a served batch in some of them. A program that records no spans
gives nothing to read."""

from typing import Optional

from htr_vt_torch.utils import logging as program


def traced_spans(rec: dict, kind: str) -> list:
    """The program's spans behind the traced record ``rec`` of kind
    ``kind``; empty for an untraced record, another kind, or a program
    without spans."""
    if rec.get("kind") != kind or not rec.get("trace"):
        return []
    return getattr(program, "spans", list)()


def host_ms_per_batch(rec: dict, names) -> Optional[float]:
    """Host ms a served batch inside the spans named ``names``, over the
    traced job's ``serve.batch`` spans; None where there are none."""
    spans = traced_spans(rec, "serve")
    batches = sum(s["name"] == "serve.batch" for s in spans)
    if not batches:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans if s["name"] in names) / 1e6 / batches
