"""Batch serving with the PyTorch port (port of ``htr_vt_tpu/cli/serve.py``):
transcribe line images to JSONL, one {"image", "text"} record per line.

    python -m htr_vt_torch.cli.serve IAM --checkpoint best_CER.pth \\
        --images 'scans/*.png' --batch-size 128 [--out preds.jsonl] \\
        [--width-buckets 512,1024,2048]

``--checkpoint`` is a directory of the port's training checkpoints (a
rolling ``checkpoint_*`` directory, ``best_CER`` / ``best_WER``, or the run
directory, meaning its latest), served with its EMA weights at the model
config saved beside them, as the JAX serve CLI serves a training checkpoint
(``serve.py:115-130``); or a ``.pth`` state_dict in the reference PyTorch
layout (what ``htr_vt_torch/utils/torch_convert.py`` reads and writes), at
the dataset preset's model config. Width buckets
(``serve.py:142-159``): each line goes, by its natural aspect-resized
width, to the smallest bucket that holds it (the widest catches the rest,
capped there), and each bucket runs fixed-size batches at its width
through the same model and weights; without buckets every line is capped
at the configured width, as the reference does. At 1024 and 2048 px (N =
256 and 512 tokens) ``attn_impl="auto"`` takes the flash-attention
kernels on the card. ``--quant int8`` serves the A8W8 model, its static
scales calibrated on each bucket's first ``--calib-batches`` batches
(``serve.py:163-190``). ``--arpa`` rescores each line on the host
(``serve.py:215-227``): a prefix beam search of ``--beam-width`` over the
port's log-probabilities, then the n-gram LM (ARPA text or a compiled
``.htlm``, ``decode/lm.py``) at ``--lm-weight`` picks among the beams.
``--selftest`` (``serve.py:78-100,270-284``) serves ``--selftest-n``
synthetic lines in place of ``--images``: each rendered at its natural
width (a length ramp of 6 to ``--selftest-max-chars`` characters), routed
through the buckets, and scored (CER / WER on stderr, overall and per
bucket) against the labels that were drawn.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import json
import os
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from htr_vt_torch.config import DataConfig, ModelConfig, dataset_preset
from htr_vt_torch import CTCLabelConverter
from htr_vt_torch.data.image import assign_width_buckets
from htr_vt_torch.data.loader import make_converter
from htr_vt_torch.decode.beam import prefix_beam_search
from htr_vt_torch.decode.lm import NgramScorer, rescore_candidates
from htr_vt_torch.models.htr_vt import HTRVT, build_model
from htr_vt_torch.ops.decode import collapse_ids, collapsed_texts
from htr_vt_torch.ops.quant import calibrate_quant_stats, serving_arrays
from htr_vt_torch.train.checkpoint import CheckpointManager, load_ema_model, saved_config
from htr_vt_torch.train.step import eval_step
from htr_vt_torch.utils.convert import load_reference_checkpoint
from htr_vt_torch.utils.logging import span

# Dummy labels of the serving step (``serve.py:211-212``): the CTC loss
# runs on every served batch, over zero-length labels.
DUMMY_LABEL_LEN = 8


# Rescores a batch's lines: (logits [n, T, C], greedy texts) -> texts.
Rescore = Callable[[torch.Tensor, List[str]], List[str]]


def beam_lm_texts(logits: torch.Tensor, greedy: Sequence[str],
                  converter: CTCLabelConverter, scorer: NgramScorer,
                  beam_width: int = 5, lm_weight: float = 1.0) -> List[str]:
    """The JAX serve CLI's rescoring (``serve.py:215-227``): per line, a
    prefix beam search of ``beam_width`` on the host over the float32
    log-softmax of its logits [T, C], each beam collapsed to text, then
    ``rescore_candidates`` with the n-gram ``scorer`` at ``lm_weight``; the
    best candidate (the greedy text when the beam is empty)."""
    logp = torch.log_softmax(logits.float(), -1).cpu().numpy()
    chars = converter.character
    texts = []
    for lp, text in zip(logp, greedy):
        beams = prefix_beam_search(lp, beam_width=beam_width)
        cands = [("".join(chars[i] for i in seq if 0 < i < len(chars)), score)
                 for seq, score in beams] or [(text, 0.0)]
        texts.append(rescore_candidates(cands, scorer, lm_weight)[0][0])
    return texts


def transcribe(model: nn.Module, images: np.ndarray,
               converter: CTCLabelConverter, batch_size: int,
               rescore: Optional[Rescore] = None) -> List[str]:
    """Greedy transcriptions of ``images`` [N, H, W, 1] float32 in [0, 1],
    each batch's rescored by ``rescore`` where given (``beam_lm_texts``).

    Runs fixed-size batches through ``ServingLoop``; the last one is padded
    with white rows (``serve.py:205-207``), whose outputs are dropped. Spans
    (``utils/logging.py``): a batch's ``serve.stack`` (the copy into the
    staging memory), ``serve.pad``, ``eval_step``'s, the previous batch's
    ``serve.decode`` and ``serve.wait``; the last batch's decode after it."""
    loop = ServingLoop(model, converter, batch_size, len(images), rescore)
    for start in range(0, len(images), batch_size):
        sel = range(start, min(start + batch_size, len(images)))
        loop.submit(loop.stage(images[start:sel.stop], batch_size), sel)
    return loop.finish()


class ServingLoop:
    """Batches through ``eval_step`` with one blocking call a batch: the wait
    on that batch's own results.

    For each batch, the caller stages its lines (``stage``: stacked into
    page-locked host memory on the card, the rows past them white) and
    submits it. ``submit`` queues the batch's copy to the card and its
    ``eval_step`` (the dummy CTC labels are zeros made on the device once),
    then ``ops/decode.py:collapse_ids`` of its lines' frame ids and their
    asynchronous fetch to the host; then decodes the previous batch on the
    host while this one runs; then waits for this batch's fetch (a CUDA
    event). So the caller loads the next batch only after that wait, and
    each forward's rows are the lines staged since the one before. ``finish``
    decodes the last batch and returns the texts, by line index. On the CPU
    nothing is page-locked and nothing waits, in the same order.

    Spans (``utils/logging.py``): ``serve.stack`` and ``serve.pad`` (in
    ``stage``), ``serve.decode`` (``overlapped`` 1 where a later batch was
    queued while it ran, 0 for the last) and ``serve.wait``."""

    def __init__(self, model: nn.Module, converter: CTCLabelConverter, batch_size: int,
                 n_lines: int, rescore: Optional[Rescore] = None):
        device = next(model.parameters()).device
        self.model, self.character, self.rescore = model, converter.character, rescore
        self.device, self.cuda = device, device.type == "cuda"
        self.labels = torch.zeros((batch_size, DUMMY_LABEL_LEN), dtype=torch.int32,
                                  device=device)
        self.label_lengths = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        self.texts: List[Optional[str]] = [None] * n_lines
        self.pending = None

    def stage(self, lines: Sequence[np.ndarray], rows: int) -> torch.Tensor:
        """``lines`` (each [H, W, 1]) stacked into [rows, H, W, 1] float32
        host memory, page-locked on the card (the caching host allocator
        hands a block back only once the copy that read it is done), the rows
        past them white (1.0)."""
        n = len(lines)
        with span("serve.stack"):
            buf = torch.empty((rows,) + lines[0].shape, dtype=torch.float32,
                              pin_memory=self.cuda)
            np.stack(lines, out=buf.numpy()[:n])
        if n < rows:
            with span("serve.pad"):
                buf[n:] = 1.0
        return buf

    @torch.inference_mode()
    def submit(self, image: torch.Tensor, sel: Sequence[int]) -> None:
        """Serve the staged batch ``image``, whose first ``len(sel)`` rows are
        lines ``sel``; returns once its collapsed ids are on the host."""
        out = eval_step(self.model, {"image": image, "labels": self.labels,
                                     "label_lengths": self.label_lengths})
        ids, lengths = collapse_ids(out["pred_ids"][:len(sel)])
        fetched = (ids.to("cpu", non_blocking=True), lengths.to("cpu", non_blocking=True))
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record()
        if self.pending is not None:
            self._decode(*self.pending, overlapped=1)
        self.pending = (sel, fetched, out["logits"][:len(sel)] if self.rescore else None)
        with span("serve.wait"):
            if done is not None:
                done.synchronize()

    def finish(self) -> List[Optional[str]]:
        """Decode the last batch; the texts, by line index."""
        if self.pending is not None:
            self._decode(*self.pending, overlapped=0)
            self.pending = None
        return self.texts

    def _decode(self, sel, fetched, logits, overlapped: int) -> None:
        with span("serve.decode", overlapped=overlapped):
            greedy = collapsed_texts(fetched[0].numpy(), fetched[1].numpy(), self.character)
        for i, text in zip(sel, greedy if logits is None else self.rescore(logits, greedy)):
            self.texts[i] = text


def route_to_buckets(widths: Sequence[int], buckets: Sequence[int],
                     stride: int) -> Tuple[List[int], List[int]]:
    """(sorted bucket widths, each line's bucket index) for natural line
    ``widths``. Bucket widths are rounded up to multiples of ``stride`` (the
    stem's width stride, ``patch_size[0]``), with the JAX CLI's note for
    each one that moved (``serve.py:146-155``)."""
    fixed = [-(-w // stride) * stride for w in buckets]
    for w, fw in zip(buckets, fixed):
        if w != fw:
            print(f"width bucket {w} rounded up to {fw} "
                  f"(widths must be multiples of {stride})")
    return assign_width_buckets(widths, fixed)


def transcribe_buckets(model: nn.Module, load: Callable[[int, int], np.ndarray],
                       widths: Sequence[int], buckets: Sequence[int],
                       converter: CTCLabelConverter, batch_size: int,
                       calib_batches: int = 4,
                       rescore: Optional[Rescore] = None) -> List[str]:
    """Greedy transcriptions of lines of natural ``widths``, in input order.

    ``load(i, width)`` returns line i as float32 [H, width, 1] at its
    bucket's width. Each bucket runs fixed-size batches of its lines
    (``transcribe``: the last batch white-padded) through one
    ``ServingLoop`` across the buckets, loading a batch only once the one
    before it has come back (``serve.py:236-254``). An int8 model is
    calibrated first on each bucket's first ``calib_batches`` batches
    (``serve.py:163-190``), each copied to the card as it is drawn.
    ``rescore`` as in ``transcribe``.

    Spans (``utils/logging.py``): ``serve.route`` (``buckets``),
    ``serve.calibrate`` a bucket (``width``, ``rows`` forwarded), and a
    request ``serve.batch`` a bucket batch (``width``, ``lines``, ``rows``
    forwarded, ``pad_rows``), each holding its ``serve.load``,
    ``serve.stack``, ``eval_step``'s spans, the previous batch's
    ``serve.decode`` and its ``serve.wait``; the last batch's
    ``serve.decode`` follows the last ``serve.batch``."""
    with span("serve.route") as sp:
        bucket_widths, owner = route_to_buckets(widths, buckets,
                                                model.cfg.patch_size[0])
        sp.set(buckets=len(bucket_widths))
    loop = ServingLoop(model, converter, batch_size, len(widths), rescore)
    for bi, width in enumerate(bucket_widths):
        idxs = [i for i, o in enumerate(owner) if o == bi]
        if model.cfg.quant == "int8":
            with span("serve.calibrate", width=width, rows=0) as sp:
                calibrate_quant_stats(model, _calibration_batches(
                    loop, load, idxs, width, batch_size, sp), calib_batches)
        for start in range(0, len(idxs), batch_size):
            sel = idxs[start:start + batch_size]
            with span("serve.batch", request=True, width=width, lines=len(sel),
                      rows=batch_size, pad_rows=batch_size - len(sel)):
                loop.submit(loop.stage(_load_lines(load, sel, width), batch_size), sel)
    return loop.finish()


def _load_lines(load: Callable[[int, int], np.ndarray], sel: Sequence[int],
                width: int) -> List[np.ndarray]:
    """Lines ``sel`` loaded at ``width``."""
    with span("serve.load"):
        return [load(i, width) for i in sel]


def _calibration_batches(loop: ServingLoop, load: Callable[[int, int], np.ndarray],
                         idxs: Sequence[int], width: int, batch_size: int, sp):
    """A bucket's batches for calibration, each loaded, staged and copied to
    the model's device (without blocking) when drawn; the span ``sp``
    counts the rows drawn."""
    rows = 0
    for start in range(0, len(idxs), batch_size):
        sel = idxs[start:start + batch_size]
        images = loop.stage(_load_lines(load, sel, width), len(sel))
        rows += len(sel)
        sp.set(rows=rows)
        yield images.to(loop.device, non_blocking=True)


class _TrainAlphabet:
    """What ``data/loader.py:make_converter`` reads of a training set, its
    alphabet, worked out only when read: the sorted synthetic alphabet for
    SYNTH, else the sorted characters of the training list."""

    def __init__(self, cfg: DataConfig, train_list: Optional[str],
                 data_path: Optional[str]):
        self.cfg, self.train_list, self.data_path = cfg, train_list, data_path

    @property
    def alphabet(self) -> List[str]:
        if self.cfg.dataset == "SYNTH":
            return sorted(set(self.cfg.synth_alphabet))
        from htr_vt_torch.data.lists import LineIndex
        return LineIndex.from_list_file(self.train_list or self.cfg.train_list,
                                        self.data_path or self.cfg.data_path,
                                        max_label_len=self.cfg.max_label_len).alphabet


def charset(dataset: str, train_list: Optional[str] = None,
            data_path: Optional[str] = None,
            data: Optional[DataConfig] = None) -> List[str]:
    """The codec alphabet the JAX serve CLI derives, by the loader's rule
    (``make_converter``: the Vietnamese charset where configured, else the
    training set's alphabet); from ``data`` (a checkpoint's saved data
    config) where given, else from the dataset preset's."""
    cfg = data or dataset_preset(dataset).data
    return make_converter(cfg, _TrainAlphabet(cfg, train_list, data_path)).character[1:]


def load_serving_model(checkpoint: str, cfg: ModelConfig, device,
                       quant: str = "none") -> HTRVT:
    """The model ``--checkpoint`` names, on ``device``, with ``quant`` set:
    a directory of the port's training checkpoints gives its EMA weights at
    the model config saved with them (``train/checkpoint.py:
    load_ema_model``); a ``.pth`` file, a state_dict in the reference
    layout, loads into a model at ``cfg``. An int8 model gets the weights
    padded to its stage 1 (``ops/quant.py:serving_arrays``)."""
    if os.path.isdir(checkpoint):
        saved = saved_config(CheckpointManager(os.path.dirname(
            os.path.abspath(checkpoint))).meta(checkpoint))
        model_cfg = None if saved is None else dataclasses.replace(saved.model,
                                                                   quant=quant)
        return load_ema_model(checkpoint, model_cfg, device)
    cfg = dataclasses.replace(cfg, quant=quant)
    model = build_model(cfg, device=torch.device(device))
    model.load_state_dict(serving_arrays(cfg, load_reference_checkpoint(checkpoint)),
                          strict=True)
    return model


def selftest_lines(n: int, max_chars: int, alphabet: str,
                   out_dir: str) -> Tuple[List[str], List[str]]:
    """The JAX serve CLI's ``--selftest`` lines (``serve.py:78-100``): n
    random texts of ``alphabet`` on a 6..96-character ramp capped at
    ``max_chars``, each rendered on a canvas of its natural width
    (``selftest_canvas_width``) from one generator seeded 0 and written to
    ``out_dir/line_{i:03d}.png``. Returns (paths, labels), a label being the
    characters that fit on the canvas."""
    from PIL import Image

    from htr_vt_torch.data.synthetic import (random_text, render_line,
                                             selftest_canvas_width, selftest_max_len)
    rng = np.random.default_rng(0)
    paths, labels = [], []
    for i in range(n):
        text = random_text(rng, alphabet, min_len=4,
                           max_len=min(max_chars, selftest_max_len(i, n)))
        img, drawn = render_line(text, 64, selftest_canvas_width(len(text)), rng=rng,
                                 return_drawn=True)
        path = os.path.join(out_dir, f"line_{i:03d}.png")
        Image.fromarray(img).save(path)
        paths.append(path)
        labels.append(text[:drawn].rstrip())
    return paths, labels


def selftest_report(texts: Sequence[str], labels: Sequence[str], owner: Sequence[int],
                    bucket_widths: Sequence[int]) -> List[str]:
    """The ``--selftest`` score lines (``serve.py:270-284``): CER and WER
    over every line, then per bucket."""
    from htr_vt_torch.text.metrics import cer_wer
    cer, wer = cer_wer(list(texts), list(labels))
    lines = [f"# selftest CER {cer:.4f} WER {wer:.4f}"]
    for bi, width in enumerate(bucket_widths):
        idxs = [i for i, o in enumerate(owner) if o == bi]
        if idxs:
            c, w = cer_wer([texts[i] for i in idxs], [labels[i] for i in idxs])
            lines.append(f"#   bucket {width:5d}: {len(idxs):3d} lines  "
                         f"CER {c:.4f}  WER {w:.4f}")
    return lines


def _image_paths(spec: str) -> Sequence[str]:
    if os.path.isfile(spec) and not spec.endswith((".png", ".jpg")):
        with open(spec) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return sorted(glob.glob(spec))


def main(argv: Optional[Sequence[str]] = None) -> None:
    from htr_vt_torch.data.image import (load_line_image,  # needs PIL
                                         natural_line_width)

    p = argparse.ArgumentParser(description="htr_vt_torch batch transcription")
    p.add_argument("dataset", help="IAM | READ | LAM | SYNTH (sets the charset)")
    p.add_argument("--checkpoint", required=True,
                   help="a training checkpoint directory of the port (rolling, "
                        "best_CER/best_WER, or the run directory: its EMA "
                        "weights are served), or a state_dict in the reference "
                        "PyTorch layout (.pth)")
    p.add_argument("--images", default=None,
                   help="glob pattern or file with one path per line")
    p.add_argument("--selftest", action="store_true",
                   help="serve self-generated synthetic lines at natural widths "
                        "instead of --images and score the transcriptions "
                        "(smoke-tests a checkpoint + bucket config without data)")
    p.add_argument("--selftest-n", type=int, default=16)
    p.add_argument("--selftest-max-chars", type=int, default=96,
                   help="cap the selftest length ramp (default 6..96 chars); set "
                        "to the trained recipe's max line length to score the "
                        "in-distribution workload separately from the "
                        "beyond-range one")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--out", default=None, help="JSONL output (default stdout)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="quantized INFERENCE path (dynamic A8W8); training is"
                        " always float")
    p.add_argument("--calib-batches", type=int, default=4,
                   help="int8: batches per bucket folded into the "
                        "running-abs-max activation calibration")
    p.add_argument("--train-list", default=None,
                   help="training list for the charset (default: the preset's)")
    p.add_argument("--data-path", default=None)
    p.add_argument("--arpa", default=None,
                   help="optional n-gram LM for beam rescoring: ARPA text or "
                        "compiled .htlm (htr_vt_torch.decode.lm_compile)")
    p.add_argument("--beam-width", type=int, default=5)
    p.add_argument("--lm-weight", type=float, default=1.0)
    p.add_argument("--width-buckets", default=None,
                   help="comma-separated widths (e.g. 512,1024,2048), each a "
                        "multiple of the stem's width stride (patch_size[0], "
                        "default 4; off-multiples are rounded up); default: "
                        "the configured width only")
    args = p.parse_args(argv)

    labels = None
    if args.selftest:
        import tempfile
        paths, labels = selftest_lines(
            args.selftest_n, args.selftest_max_chars,
            dataset_preset(args.dataset).data.synth_alphabet,
            tempfile.mkdtemp(prefix="htrvt_selftest_"))
    elif args.images:
        paths = _image_paths(args.images)
        if not paths:
            sys.exit(f"no images match {args.images!r}")
    else:
        p.error("one of --images / --selftest is required")
    saved = None
    if os.path.isdir(args.checkpoint):
        saved = saved_config(CheckpointManager(os.path.dirname(
            os.path.abspath(args.checkpoint))).meta(args.checkpoint))
    converter = CTCLabelConverter(charset(args.dataset, args.train_list,
                                          args.data_path,
                                          saved.data if saved else None))
    cfg = dataclasses.replace(dataset_preset(args.dataset).model,
                              nb_cls=converter.num_classes)
    model = load_serving_model(args.checkpoint, cfg, args.device, args.quant)
    if model.cfg.nb_cls != converter.num_classes:
        sys.exit(f"{args.checkpoint}: {model.cfg.nb_cls} classes, but the charset "
                 f"gives {converter.num_classes}")
    h, w = model.cfg.img_size
    if args.width_buckets:
        buckets = [int(x) for x in args.width_buckets.split(",") if x.strip()]
        widths = [natural_line_width(path, h) for path in paths]
    else:
        buckets, widths = [w], [w] * len(paths)
    rescore = None
    if args.arpa:
        rescore = functools.partial(beam_lm_texts, converter=converter,
                                    scorer=NgramScorer(args.arpa),
                                    beam_width=args.beam_width,
                                    lm_weight=args.lm_weight)
    t0 = time.perf_counter()
    # one batch of a bucket at a time: host memory stays at one batch
    texts = transcribe_buckets(
        model, lambda i, width: load_line_image(paths[i], width, h), widths,
        buckets, converter, args.batch_size, args.calib_batches, rescore)
    sink = open(args.out, "w") if args.out else sys.stdout
    try:
        for path, text in zip(paths, texts):
            sink.write(json.dumps({"image": path, "text": text},
                                  ensure_ascii=False) + "\n")
    finally:
        if args.out:
            sink.close()
    dt = time.perf_counter() - t0
    print(f"# {len(paths)} images in {dt:.2f}s ({len(paths) / dt:.1f} img/s)",
          file=sys.stderr)
    if labels is not None:
        stride = model.cfg.patch_size[0]
        bucket_widths, owner = assign_width_buckets(
            widths, [-(-w // stride) * stride for w in buckets])
        for line in selftest_report(texts, labels, owner, bucket_widths):
            print(line, file=sys.stderr)


if __name__ == "__main__":
    main()
