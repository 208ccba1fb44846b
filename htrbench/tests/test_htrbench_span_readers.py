"""The readers of the program's spans (``metrics/*.py`` with ``source``
``program_span``, through ``program_spans.py``) on a synthetic span list:
None on an untraced record, on an empty list, on a job with no served
batch and on a program without spans, and the right number on a known
list."""

import pytest

from htr_vt_torch.utils import logging as program
from htrbench.manifest import Bench

BENCH = Bench()
SERVE = ("host_serial_ms.serve", "h2d_ms.serve", "decode_ms.serve", "rows_per_line.serve")
TRACED = {"kind": "serve", "trace": {"busy_s": 1.0}, "unit_s": 1.0}


def _span(name, ms=0.0, **attrs):
    _span.t += 1_000_000_000
    return {"name": name, "id": _span.t, "parent": None, "request": None,
            "start_ns": _span.t, "end_ns": _span.t + int(ms * 1e6), "attrs": attrs}


_span.t = 0

# one job: route, one bucket's calibration of 2 batches (256 rows), then a
# full batch and a ragged one of 64 lines
CALIBRATION = ([_span("serve.route", 1.0, buckets=1),
                _span("serve.calibrate", 30.0, width=512, rows=256)]
               + [_span("serve.load", 2.0), _span("serve.stack", 3.0)] * 2)
SERVE_SPANS = CALIBRATION + [
    _span("serve.batch", 40.0, width=512, lines=128, rows=128, pad_rows=0),
    _span("serve.load", 2.0), _span("serve.stack", 3.0), _span("eval.h2d", 4.0),
    _span("eval.forward", 20.0), _span("eval.loss", 1.0), _span("eval.argmax", 0.5),
    _span("serve.decode", 7.0),
    _span("serve.batch", 40.0, width=512, lines=64, rows=128, pad_rows=64),
    _span("serve.load", 1.0), _span("serve.stack", 1.5), _span("serve.pad", 1.0),
    _span("eval.h2d", 4.0), _span("eval.forward", 20.0), _span("eval.loss", 1.0),
    _span("eval.argmax", 0.5), _span("serve.decode", 5.0)]
WANT = {
    # route 1 + loads 2+2+2+1 + stacks 3+3+3+1.5 + pad 1 + h2d 4+4 + decode 7+5, over 2 batches
    "host_serial_ms.serve": (1 + 7 + 10.5 + 1 + 8 + 12) / 2,
    "h2d_ms.serve": 4.0,
    "decode_ms.serve": 6.0,
    "rows_per_line.serve": (128 + 128 + 256) / 192,
}


@pytest.mark.parametrize("metric", SERVE)
def test_reader_on_a_known_span_list(monkeypatch, metric):
    monkeypatch.setattr(program, "spans", lambda: SERVE_SPANS)
    got = BENCH.reader(metric)(TRACED)
    assert isinstance(got, float) and got == pytest.approx(WANT[metric])
    assert BENCH.reader(metric)(dict(TRACED, kind="train")) is None


@pytest.mark.parametrize("metric", SERVE)
def test_reader_reads_nothing_where_there_is_nothing(monkeypatch, metric):
    read = BENCH.reader(metric)
    monkeypatch.setattr(program, "spans", lambda: SERVE_SPANS)
    assert read({"kind": "serve", "unit_s": 1.0}) is None  # untraced
    monkeypatch.setattr(program, "spans", lambda: [])
    assert read(TRACED) is None
    monkeypatch.delattr(program, "spans")  # a program that records no spans
    assert read(TRACED) is None


@pytest.mark.parametrize("metric", SERVE)
def test_reader_needs_a_served_batch(monkeypatch, metric):
    """Spans with no ``serve.batch`` among them (a calibration alone) give
    no denominator."""
    monkeypatch.setattr(program, "spans", lambda: CALIBRATION)
    assert BENCH.reader(metric)(TRACED) is None


def test_every_span_metric_is_listed_with_its_cells():
    listed = {m["name"]: m for m in BENCH.spec["per_layer"] if m["source"] == "program_span"}
    assert set(listed) == set(SERVE)
    for m in listed.values():
        assert m["workloads"] == ["iam-int8-serve-512", "iam-serve-512"]
        assert m["moves"] == "serve_lines_s"
