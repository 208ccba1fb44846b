"""The reader of ``wait_ms.serve`` (``metrics/wait_ms.serve.py``) on
synthetic span lists: the host ms a served batch in ``serve.wait``; None on
an untraced record, another kind, no spans, a program without spans, a
job with no served batch, and a program whose loop records no
``serve.wait`` (one that blocks elsewhere)."""

import pytest

from htr_vt_torch.utils import logging as program
from htrbench.manifest import Bench

BENCH = Bench()
TRACED = {"kind": "serve", "trace": {"busy_s": 1.0}, "unit_s": 1.0}


def _spans(waits):
    """A job of len(waits) served batches, each with its spans and a
    ``serve.wait`` of the given ms where it is not None."""
    out, t = [{"name": "serve.route", "start_ns": 0, "end_ns": 10**6, "attrs": {}}], 0
    for ms in waits:
        t += 10**9
        out.append({"name": "serve.batch", "start_ns": t, "end_ns": t + 5 * 10**7,
                    "attrs": {"width": 512, "lines": 128, "rows": 128, "pad_rows": 0}})
        for name in ("serve.load", "serve.stack", "eval.h2d", "eval.forward", "serve.decode"):
            out.append({"name": name, "start_ns": t, "end_ns": t + 10**6, "attrs": {}})
        if ms is not None:
            out.append({"name": "serve.wait", "start_ns": t, "end_ns": t + int(ms * 1e6),
                        "attrs": {}})
    return out


def test_wait_reader_on_a_known_span_list(monkeypatch):
    read = BENCH.reader("wait_ms.serve")
    monkeypatch.setattr(program, "spans", lambda: _spans([12.0, 20.0, 0.0, 4.0]))
    got = read(TRACED)
    assert isinstance(got, float) and got == pytest.approx(9.0)
    assert read(dict(TRACED, kind="train")) is None
    assert read({"kind": "serve", "unit_s": 1.0}) is None  # untraced


def test_wait_reader_reads_nothing_where_there_is_nothing(monkeypatch):
    read = BENCH.reader("wait_ms.serve")
    monkeypatch.setattr(program, "spans", lambda: _spans([None, None]))  # no serve.wait
    assert read(TRACED) is None
    monkeypatch.setattr(program, "spans", lambda: _spans([])[:1])  # no served batch
    assert read(TRACED) is None
    monkeypatch.setattr(program, "spans", lambda: [])
    assert read(TRACED) is None
    monkeypatch.delattr(program, "spans")  # a program that records no spans
    assert read(TRACED) is None


def test_wait_metric_is_listed_with_the_serving_cells():
    (m,) = [m for m in BENCH.spec["per_layer"] if m["name"] == "wait_ms.serve"]
    assert m == {"name": "wait_ms.serve", "unit": "ms", "better": "lower",
                 "source": "program_span", "layer": "entry", "moves": "serve_lines_s",
                 "workloads": ["iam-int8-serve-512", "iam-serve-512"]}
