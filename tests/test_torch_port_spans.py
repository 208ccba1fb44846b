"""The program's spans (``htr_vt_torch/utils/logging.py``) on the CPU.

Without a profiler ``transcribe_buckets`` and ``train_step`` record
nothing. Under the active step of a ``torch.profiler`` schedule (its
warm-up step records nothing) the serving spans form the tree the
benchmark's readers walk: one ``serve.route``, a ``serve.calibrate`` a
bucket for int8, a request ``serve.batch`` a bucket batch holding its
loads, stack, padding, ``eval_step``'s phases, the previous batch's decode
and its wait, and the last batch's decode after them; a SAM step is one
request ``train.step`` holding a ``train.forward`` / ``train.backward`` pair
a masked forward (tri-masked, under ``grad_accum``) and one perturb, update
and EMA. Each span lies inside the profiler's own ``htrvt.*`` event. Also
the span store itself (attributes set inside a span, a parent stack a
thread, an exception), and that ``calibrate_quant_stats`` draws no batch
it does not forward. Tiny configs: embed 64, depth 1, 64 x 128 px.
"""

import dataclasses
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from htr_vt_torch import CTCLabelConverter
from htr_vt_torch.cli import serve
from htr_vt_torch.config import (ExperimentConfig, MaskConfig, ModelConfig, OptimConfig,
                                 TrainConfig)
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import quant as q8
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import train_step
from htr_vt_torch.utils import logging as obs
from htrbench.manifest import Bench

TINY = ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=1, num_heads=2,
                   compute_dtype="float32",
                   masking=MaskConfig(mode="span", ratio=0.2, max_span_length=2))
BS = 4
# 6 lines in the 128-px bucket (a full batch and a ragged one of 2) and 3 in
# the 256-px bucket (one ragged batch)
WIDTHS = [100, 300, 128, 90, 250, 60, 120, 200, 110]
BUCKETS = [128, 256]
# a served batch's spans in order; the first batch of a job has no previous
# batch to decode, and a full batch no padding
BATCH_CHILDREN = ("serve.load", "serve.stack", "serve.pad", "eval.h2d", "eval.forward",
                  "eval.loss", "eval.argmax", "serve.decode", "serve.wait")


@pytest.fixture(autouse=True)
def fresh_spans():
    obs.clear_spans()
    yield
    obs.clear_spans()


def profiled(fn):
    """``fn`` under the warm-up step, then the active step, of a
    ``torch.profiler`` schedule (the benchmark's traced stretch); returns
    the spans the warm-up left, the spans after, and the profiler's
    events."""
    events = []
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU], schedule=schedule,
            on_trace_ready=lambda p: events.extend(p.profiler.kineto_results.events())
    ) as prof:
        fn()
        warm = obs.spans()
        prof.step()
        fn()
        prof.step()
    return warm, obs.spans(), events


def _serve_setup(quant="none"):
    model = build_model(dataclasses.replace(TINY, quant=quant), device="cpu",
                        generator=torch.Generator().manual_seed(1))
    converter = CTCLabelConverter(list("abcdefg"))
    rng = np.random.default_rng(3)
    pool = {w: rng.random((64, w, 1), dtype=np.float32) for w in BUCKETS}
    loads = []

    def load(i, width):
        loads.append(i)
        return pool[width]

    def job():
        return serve.transcribe_buckets(model, load, WIDTHS, BUCKETS, converter, BS,
                                        calib_batches=1)
    return job, loads


def _children(recs, parent):
    return [r for r in recs if r["parent"] == parent["id"]]


def _assert_inside_profiler_events(recs, events):
    """Each span lies inside its ``htrvt.<name>`` event of the profiler, the
    n-th span of a name in the n-th event of that name."""
    by = {}
    for ev in events:
        if ev.name().startswith("htrvt."):
            by.setdefault(ev.name()[len("htrvt."):], []).append(ev)
    names = Counter(r["name"] for r in recs)
    assert {k: len(v) for k, v in by.items()} == dict(names)
    for name, evs in by.items():
        evs = sorted(evs, key=lambda e: e.start_ns())
        ours = sorted((r for r in recs if r["name"] == name), key=lambda r: r["start_ns"])
        for ev, r in zip(evs, ours):
            assert r["start_ns"] <= ev.start_ns() <= ev.end_ns() <= r["end_ns"], name


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_no_profiler_records_no_span(quant):
    job, _ = _serve_setup(quant)
    job()
    exp = ExperimentConfig(model=TINY, optim=OptimConfig(max_lr=1e-3, warmup_iters=2,
                                                         total_iters=4))
    state = create_train_state(exp, "cpu", torch.Generator().manual_seed(0))
    train_step(state, _train_batch())
    assert obs.spans() == []


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serving_span_tree(quant):
    job, loads = _serve_setup(quant)
    warm, recs, events = profiled(job)
    assert warm == []
    assert all(r["end_ns"] >= r["start_ns"] for r in recs)
    tops = [r for r in recs if r["parent"] is None]
    route = tops[0]
    assert (route["name"], route["request"], route["attrs"]) == ("serve.route", None,
                                                                 {"buckets": 2})
    assert not _children(recs, route)

    batches = [r for r in tops if r["name"] == "serve.batch"]
    assert [(b["attrs"]["width"], b["attrs"]["lines"], b["attrs"]["rows"],
             b["attrs"]["pad_rows"]) for b in batches] == [(128, 4, 4, 0), (128, 2, 4, 2),
                                                          (256, 3, 4, 1)]
    requests = [b["request"] for b in batches]
    assert None not in requests and len(set(requests)) == 3
    for j, b in enumerate(batches):
        kids = _children(recs, b)
        want = [n for n in BATCH_CHILDREN
                if not (n == "serve.pad" and b["attrs"]["pad_rows"] == 0)
                and not (n == "serve.decode" and j == 0)]
        assert [k["name"] for k in kids] == want
        assert {k["request"] for k in kids} == {b["request"]}
        assert all(not _children(recs, k) for k in kids)

    # one wait and one decode a batch, in order: batch j's decode after its
    # wait, inside batch j + 1 once that batch is queued (overlapped), the
    # job's last after the last batch
    waits = [r for r in recs if r["name"] == "serve.wait"]
    decodes = [r for r in recs if r["name"] == "serve.decode"]
    assert len(waits) == len(decodes) == len(batches)
    assert [w["parent"] for w in waits] == [b["id"] for b in batches]
    assert [d["parent"] for d in decodes] == [b["id"] for b in batches[1:]] + [None]
    assert [d["attrs"] for d in decodes] == [{"overlapped": 1}] * 2 + [{"overlapped": 0}]
    for d, w in zip(decodes, waits):
        assert d["start_ns"] >= w["end_ns"]
    for d, b in zip(decodes, batches[1:]):
        (argmax,) = [k for k in _children(recs, b) if k["name"] == "eval.argmax"]
        assert d["start_ns"] >= argmax["end_ns"]
    assert tops[-1] is decodes[-1] and decodes[-1]["start_ns"] >= batches[-1]["end_ns"]

    calib = [r for r in tops if r["name"] == "serve.calibrate"]
    if quant == "none":
        assert len(tops) == 5
        assert len(loads) == 2 * len(WIDTHS)  # the warm-up job, then the traced one
        rows_per_line = 12 / 9
    else:
        # calib_batches=1: the first batch of each bucket (4 rows, then the
        # 256-px bucket's ragged 3), loaded and stacked once, no more
        assert [(c["attrs"]["width"], c["attrs"]["rows"], c["request"]) for c in calib] == \
            [(128, 4, None), (256, 3, None)]
        for c in calib:
            assert Counter(k["name"] for k in _children(recs, c)) == \
                Counter({"serve.load": 1, "serve.stack": 1})
        assert len(loads) == 2 * (len(WIDTHS) + 4 + 3)
        rows_per_line = (12 + 4 + 3) / 9
    _assert_inside_profiler_events(recs, events)

    read = Bench().reader("rows_per_line.serve")
    assert read({"kind": "serve", "trace": {"busy_s": 1.0}}) == pytest.approx(rows_per_line)
    assert read({"kind": "serve"}) is None


def _train_batch(b=4, lmax=5, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, lmax + 1, b).astype(np.int32)
    labels = rng.integers(1, TINY.nb_cls, (b, lmax)).astype(np.int32)
    labels[np.arange(lmax)[None] >= lengths[:, None]] = 0
    return {"image": rng.random((b, 64, 128, 1), dtype=np.float32), "labels": labels,
            "label_lengths": lengths}


@pytest.mark.parametrize("tri_masked", [False, True])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_spans(tri_masked, grad_accum):
    exp = ExperimentConfig(model=TINY,
                           optim=OptimConfig(max_lr=1e-3, warmup_iters=2, total_iters=6),
                           train=TrainConfig(tri_masked=tri_masked, grad_accum=grad_accum))
    state = create_train_state(exp, "cpu", torch.Generator().manual_seed(0))
    batch = _train_batch()

    def two_steps():
        train_step(state, batch)
        train_step(state, batch)

    warm, recs, events = profiled(two_steps)
    assert warm == []
    steps = [r for r in recs if r["name"] == "train.step"]
    assert [s["attrs"]["step"] for s in steps] == [2, 3]
    assert all(s["parent"] is None and s["request"] is not None for s in steps)
    assert len({s["request"] for s in steps}) == 2
    k = (3 if tri_masked else 1) * grad_accum
    for s in steps:
        kids = _children(recs, s)
        assert {r["request"] for r in kids} == {s["request"]}
        assert [r["name"] for r in kids] == (
            ["train.forward", "train.backward"] * k + ["train.perturb"]
            + ["train.forward", "train.backward"] * k + ["train.update", "train.ema"])
        assert all(not _children(recs, r) for r in kids)
    assert len(recs) == 2 * (1 + 4 * k + 3)
    _assert_inside_profiler_events(recs, events)


def test_transcribe_pads_only_the_ragged_batch():
    """``transcribe`` alone over 6 lines at batch 4: a stack, a wait and a
    decode a batch (the first batch's once the second is queued), the white
    padding only in the second; its spans open no request."""
    model = build_model(TINY, device="cpu", generator=torch.Generator().manual_seed(1))
    images = np.random.default_rng(4).random((6, 64, 128, 1), dtype=np.float32)
    out = []
    _, recs, _ = profiled(lambda: out.append(serve.transcribe(
        model, images, CTCLabelConverter(list("abcdefg")), BS)))
    assert len(out[-1]) == 6
    assert [r["name"] for r in recs] == [
        "serve.stack", "eval.h2d", "eval.forward", "eval.loss", "eval.argmax", "serve.wait",
        "serve.stack", "serve.pad", "eval.h2d", "eval.forward", "eval.loss", "eval.argmax",
        "serve.decode", "serve.wait", "serve.decode"]
    assert [r["attrs"] for r in recs if r["name"] == "serve.decode"] == [
        {"overlapped": 1}, {"overlapped": 0}]
    assert all(r["parent"] is None and r["request"] is None for r in recs)


def test_eval_step_spans_nest_in_an_open_request():
    model = build_model(TINY, device="cpu", generator=torch.Generator().manual_seed(1))
    batch = {"image": np.ones((2, 64, 128, 1), np.float32),
             "labels": np.zeros((2, 3), np.int32), "label_lengths": np.zeros((2,), np.int32)}

    def job():
        with obs.span("serve.batch", request=True, lines=2):
            serve.eval_step(model, batch)
    _, recs, events = profiled(job)
    top, *kids = recs
    assert [k["name"] for k in kids] == ["eval.h2d", "eval.forward", "eval.loss",
                                         "eval.argmax"]
    assert all(k["parent"] == top["id"] and k["request"] == top["request"] for k in kids)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(kids, kids[1:]))
    _assert_inside_profiler_events(recs, events)


def test_no_profiler_gives_the_shared_null_span():
    sp = obs.span("serve.batch", request=True, lines=3)
    assert sp is obs.span("eval.h2d") is obs._NULL
    with sp as inner:
        inner.set(rows=4)
    assert obs.spans() == []


def _recording(fn):
    """``fn`` under an active ``torch.profiler`` step; the spans after."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    return obs.spans()


def test_span_attributes_set_inside_and_cleared():
    def job():
        with obs.span("serve.calibrate", width=128, rows=0) as sp:
            sp.set(rows=4)
            sp.set(rows=7, extra=1)
    (rec,) = _recording(job)
    assert rec["attrs"] == {"width": 128, "rows": 7, "extra": 1}
    assert rec["parent"] is None and rec["request"] is None
    obs.clear_spans()
    assert obs.spans() == []


def test_each_thread_keeps_its_own_parent_stack():
    """A span opened on another thread while the first waits inside its own
    (as on autograd's backward threads, which carry the profiler's state;
    a plain thread does not, so it opens the recording span itself) is no
    child of it."""
    def other_thread():
        with obs._Span("train.backward", False, {}):
            pass

    def job():
        with obs.span("train.step", request=True):
            worker = threading.Thread(target=other_thread)
            with obs.span("train.forward"):
                worker.start()
                worker.join()
    recs = {r["name"]: r for r in _recording(job)}
    step = recs["train.step"]
    assert recs["train.forward"]["parent"] == step["id"]
    assert recs["train.forward"]["request"] == step["request"] is not None
    assert recs["train.backward"]["parent"] is None
    assert recs["train.backward"]["request"] is None


def test_a_span_closes_on_an_exception():
    def job():
        with obs.span("serve.batch", request=True):
            with pytest.raises(ValueError):
                with obs.span("serve.load"):
                    raise ValueError("no such line")
            with obs.span("serve.stack"):
                pass
    recs = {r["name"]: r for r in _recording(job)}
    assert recs["serve.load"]["end_ns"] >= recs["serve.load"]["start_ns"]
    assert recs["serve.stack"]["parent"] == recs["serve.batch"]["id"]


def test_calibration_draws_only_the_batches_it_forwards():
    model = build_model(dataclasses.replace(TINY, quant="int8"), device="cpu",
                        generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(7)
    images = [rng.random((2, 64, 128, 1), dtype=np.float32) * s for s in (0.1, 1.0, 5.0)]
    drawn = []

    def batches():
        for i, img in enumerate(images):
            drawn.append(i)
            yield img

    got = {k: v.clone() for k, v in q8.calibrate_quant_stats(model, batches(), 2).items()}
    assert drawn == [0, 1]
    want = q8.calibrate_quant_stats(model, images[:2], 2)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    drawn.clear()
    q8.calibrate_quant_stats(model, batches(), 0)  # at least one batch
    assert drawn == [0]
