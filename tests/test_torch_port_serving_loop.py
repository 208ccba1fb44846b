"""The serving loop (``cli/serve.py:ServingLoop``) on the CPU.

The host's texts of ``ops/decode.py:collapse_ids``' output against
``CTCLabelConverter.decode_batch`` of the frame ids; the order the loop
keeps (each forward's rows are the lines loaded since the one before, white
rows after them; no line of a batch loaded before the batch ahead of it has
come back; each batch decoded once the next one is queued); its texts
against a serial loop of ``eval_step`` and ``decode_batch`` a batch, float
and int8, with the rescoring hook handed each batch's own logits. Tiny
configs: embed 64, depth 1, 64 x 128 px.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from htr_vt_torch import CTCLabelConverter
from htr_vt_torch.cli import serve
from htr_vt_torch.config import MaskConfig, ModelConfig
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import quant as q8
from htr_vt_torch.ops.decode import collapse_ids, collapsed_texts
from htr_vt_torch.train.step import eval_step

TINY = ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=1, num_heads=2,
                   compute_dtype="float32",
                   masking=MaskConfig(mode="span", ratio=0.2, max_span_length=2))
BS = 4
# the 128-px bucket: lines 0, 2, 3, 5, 6, 8 (a full batch, a ragged one of
# 2); the 256-px bucket: lines 1, 4, 7 (one ragged batch)
WIDTHS = [100, 300, 128, 90, 250, 60, 120, 200, 110]
BUCKETS = [128, 256]
# 5 characters and the blank: the model's ids 6 and 7 lie past the alphabet
CONVERTER = CTCLabelConverter(list("abcde"))

FRAME_IDS = {
    "repeats": [[1, 1, 2, 2, 2, 3, 1, 1]],
    "blanks": [[0, 1, 0, 1, 0, 0, 2, 0], [2, 0, 0, 2, 2, 0, 2, 2]],
    "past_the_alphabet": [[7, 7, 1, 7, 1, 6, 6, 2], [1, 6, 1, 1, 9, 9, 3, 6]],
    "all_blank": [[0] * 8, [6, 6, 0, 7, 0, 0, 9, 9], [0, 0, 0, 0, 0, 0, 0, 3]],
    "a_run_across_the_row_end": [[1, 2, 3, 3], [3, 3, 1, 0], [0, 1, 1, 1]],
    "random": np.random.default_rng(11).integers(0, 9, (16, 32)).tolist(),
}


@pytest.mark.parametrize("case", sorted(FRAME_IDS))
def test_collapsed_texts_match_decode_batch(case):
    ids = np.asarray(FRAME_IDS[case], np.int32)
    collapsed, lengths = collapse_ids(torch.from_numpy(ids))
    got = collapsed_texts(collapsed.numpy(), lengths.numpy(), CONVERTER.character)
    assert got == CONVERTER.decode_batch(ids)


def _model(quant):
    return build_model(dataclasses.replace(TINY, quant=quant), device="cpu",
                       generator=torch.Generator().manual_seed(1))


def _lines():
    """A distinct line image per line and bucket width, and ``load``."""
    rng = np.random.default_rng(5)
    lines = {(i, w): rng.random((64, w, 1), dtype=np.float32)
             for i in range(len(WIDTHS)) for w in BUCKETS}
    return lines, lambda i, width: lines[i, width]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_the_serving_loop_keeps_the_order(monkeypatch, quant):
    """A ragged two-bucket job (calibration included for int8), in the
    order the loop makes its calls: each forward's rows are exactly the
    lines loaded since the forward before, white rows after them; after a
    served batch's forward comes the previous batch's decode and then its
    own wait, and only then the next load."""
    model = _model(quant)
    lines, load = _lines()
    log = []

    def logged_load(i, width):
        log.append(("load", (i, width)))
        return load(i, width)

    model.register_forward_pre_hook(lambda module, args: log.append(("forward", args[0].clone())))
    real = serve.span

    @contextlib.contextmanager
    def logged(name, request=False, **attrs):
        log.append(("open", name))
        with real(name, request, **attrs) as sp:
            yield sp
        log.append(("close", name))
    monkeypatch.setattr(serve, "span", logged)
    serve.transcribe_buckets(model, logged_load, WIDTHS, BUCKETS, CONVERTER, BS,
                             calib_batches=1)

    forwards = [k for k, (what, _) in enumerate(log) if what == "forward"]
    served, since = [], []
    for k, (what, x) in enumerate(log):
        if what == "load":
            since.append(x)
        elif what == "forward":
            assert since, "a forward with no line loaded since the one before"
            want = np.stack([lines[key] for key in since])
            assert torch.equal(x[:len(since)], torch.from_numpy(want))
            assert bool((x[len(since):] == 1.0).all())
            in_batch = sum(1 if e == ("open", "serve.batch") else
                           -1 if e == ("close", "serve.batch") else 0 for e in log[:k])
            if in_batch:
                assert x.shape[0] == BS
                served.append((k, [i for i, _ in since]))
            else:  # a calibration batch: its lines alone
                assert x.shape[0] == len(since)
            since = []
    assert [sel for _, sel in served] == [[0, 2, 3, 5], [6, 8], [1, 4, 7]]
    if quant == "int8":
        assert len(forwards) == 5  # a calibration forward a bucket
    for j, (k, _) in enumerate(served):
        after = log[k + 1:]
        wait = after.index(("close", "serve.wait"))
        loads = [m for m, e in enumerate(after) if e[0] == "load"]
        assert not loads or loads[0] > wait
        # the batch before this one decoded between this forward and its wait
        assert after[:wait].count(("open", "serve.decode")) == (1 if j else 0)
    # the job's last batch decoded at its end
    assert log[-2:] == [("open", "serve.decode"), ("close", "serve.decode")]
    assert log.count(("open", "serve.decode")) == len(served)


def _serial_texts(model, load, quant, rescore=None):
    """A serial loop: each bucket's batches stacked and padded with white
    on the host, ``eval_step`` on numpy arrays, ``decode_batch``; int8
    calibrated first on the bucket's first batch, as the loop's
    ``calib_batches=1``."""
    texts = [None] * len(WIDTHS)
    bucket_widths, owner = serve.route_to_buckets(WIDTHS, BUCKETS, TINY.patch_size[0])
    for bi, width in enumerate(bucket_widths):
        idxs = [i for i, o in enumerate(owner) if o == bi]
        if quant == "int8":
            q8.calibrate_quant_stats(model, [np.stack([load(i, width) for i in idxs[:BS]])], 1)
        for start in range(0, len(idxs), BS):
            sel = idxs[start:start + BS]
            chunk = np.ones((BS, 64, width, 1), np.float32)
            chunk[:len(sel)] = np.stack([load(i, width) for i in sel])
            out = eval_step(model, {"image": chunk,
                                    "labels": np.zeros((BS, serve.DUMMY_LABEL_LEN), np.int32),
                                    "label_lengths": np.zeros((BS,), np.int32)})
            greedy = CONVERTER.decode_batch(out["pred_ids"][:len(sel)].numpy())
            if rescore is not None:
                greedy = rescore(out["logits"][:len(sel)], greedy)
            for i, text in zip(sel, greedy):
                texts[i] = text
    return texts


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_the_serving_loop_gives_a_serial_loops_texts(quant):
    """The texts of ``transcribe_buckets`` equal a serial loop's, and a
    rescoring hook gets each batch's own logits and greedy texts, though
    the loop decodes a batch only once the next one is queued."""
    model = _model(quant)
    _, load = _lines()
    seen = {"loop": [], "serial": []}

    def rescorer(key):
        def rescore(logits, greedy):
            seen[key].append((logits.clone(), list(greedy)))
            return [f"{t}|{len(seen[key])}" for t in greedy]
        return rescore

    got = serve.transcribe_buckets(model, load, WIDTHS, BUCKETS, CONVERTER, BS,
                                   calib_batches=1)
    want = _serial_texts(model, load, quant)
    assert got == want
    assert len(set(want)) > 3 and any(want)  # the lines read apart
    got = serve.transcribe_buckets(model, load, WIDTHS, BUCKETS, CONVERTER, BS,
                                   calib_batches=1, rescore=rescorer("loop"))
    assert got == _serial_texts(model, load, quant, rescorer("serial"))
    assert len(seen["loop"]) == len(seen["serial"]) == 3
    for (a, ga), (b, gb) in zip(seen["loop"], seen["serial"]):
        assert torch.equal(a, b) and ga == gb


def test_transcribe_gives_a_serial_loops_texts():
    """``transcribe`` over 6 stacked lines at batch 4 (the second batch
    ragged) against ``eval_step`` + ``decode_batch`` a batch."""
    model = _model("none")
    images = np.random.default_rng(8).random((6, 64, 128, 1), dtype=np.float32)
    want = []
    for start in (0, 4):
        chunk = np.ones((BS, 64, 128, 1), np.float32)
        chunk[:len(images[start:start + BS])] = images[start:start + BS]
        out = eval_step(model, {"image": chunk,
                                "labels": np.zeros((BS, serve.DUMMY_LABEL_LEN), np.int32),
                                "label_lengths": np.zeros((BS,), np.int32)})
        want += CONVERTER.decode_batch(out["pred_ids"][:len(images[start:start + BS])].numpy())
    assert serve.transcribe(model, images, CONVERTER, BS) == want
