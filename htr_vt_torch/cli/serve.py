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
kernels on the card. int8 and beam/LM rescoring are not ported yet
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import argparse
import dataclasses
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
from htr_vt_torch.models.htr_vt import HTRVT, build_model
from htr_vt_torch.train.checkpoint import CheckpointManager, load_ema_model, saved_config
from htr_vt_torch.train.step import eval_step
from htr_vt_torch.utils.convert import load_reference_checkpoint

# Dummy labels of the serving step (``serve.py:211-212``): the CTC loss
# runs on every served batch, over zero-length labels.
DUMMY_LABEL_LEN = 8


def transcribe(model: nn.Module, images: np.ndarray,
               converter: CTCLabelConverter, batch_size: int) -> List[str]:
    """Greedy transcriptions of ``images`` [N, H, W, 1] float32 in [0, 1].

    Runs ``eval_step`` on fixed-size batches; the last one is padded with
    white rows (``serve.py:205-207``), whose outputs are dropped."""
    texts: List[str] = []
    for start in range(0, len(images), batch_size):
        chunk = np.asarray(images[start:start + batch_size], np.float32)
        n = len(chunk)
        if n < batch_size:
            pad = np.ones((batch_size - n,) + chunk.shape[1:], np.float32)
            chunk = np.concatenate([chunk, pad])
        out = eval_step(model, {
            "image": chunk,
            "labels": np.zeros((batch_size, DUMMY_LABEL_LEN), np.int32),
            "label_lengths": np.zeros((batch_size,), np.int32)})
        texts.extend(converter.decode_batch(out["pred_ids"][:n].cpu().numpy()))
    return texts


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
                       converter: CTCLabelConverter, batch_size: int) -> List[str]:
    """Greedy transcriptions of lines of natural ``widths``, in input order.

    ``load(i, width)`` returns line i as float32 [H, width, 1] at its
    bucket's width. Each bucket runs ``eval_step`` on fixed-size batches of
    its lines (``transcribe``: the last batch white-padded), loading one
    batch at a time (``serve.py:236-254``)."""
    bucket_widths, owner = route_to_buckets(widths, buckets,
                                            model.cfg.patch_size[0])
    texts: List[Optional[str]] = [None] * len(widths)
    for bi, width in enumerate(bucket_widths):
        idxs = [i for i, o in enumerate(owner) if o == bi]
        for start in range(0, len(idxs), batch_size):
            sel = idxs[start:start + batch_size]
            images = np.stack([load(i, width) for i in sel])
            for i, text in zip(sel, transcribe(model, images, converter,
                                               batch_size)):
                texts[i] = text
    return texts


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


def load_serving_model(checkpoint: str, cfg: ModelConfig, device) -> HTRVT:
    """The model ``--checkpoint`` names, on ``device``: a directory of the
    port's training checkpoints gives its EMA weights at the model config
    saved with them (``train/checkpoint.py:load_ema_model``); a ``.pth``
    file, a state_dict in the reference layout, loads into a model at
    ``cfg``."""
    if os.path.isdir(checkpoint):
        return load_ema_model(checkpoint, None, device)
    model = build_model(cfg, device=torch.device(device))
    model.load_state_dict(load_reference_checkpoint(checkpoint), strict=True)
    return model


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
    p.add_argument("--images", required=True,
                   help="glob pattern or file with one path per line")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--out", default=None, help="JSONL output (default stdout)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--train-list", default=None,
                   help="training list for the charset (default: the preset's)")
    p.add_argument("--data-path", default=None)
    p.add_argument("--width-buckets", default=None,
                   help="comma-separated widths (e.g. 512,1024,2048), each a "
                        "multiple of the stem's width stride (patch_size[0], "
                        "default 4; off-multiples are rounded up); default: "
                        "the configured width only")
    args = p.parse_args(argv)

    paths = _image_paths(args.images)
    if not paths:
        sys.exit(f"no images match {args.images!r}")
    saved = None
    if os.path.isdir(args.checkpoint):
        saved = saved_config(CheckpointManager(os.path.dirname(
            os.path.abspath(args.checkpoint))).meta(args.checkpoint))
    converter = CTCLabelConverter(charset(args.dataset, args.train_list,
                                          args.data_path,
                                          saved.data if saved else None))
    cfg = dataclasses.replace(dataset_preset(args.dataset).model,
                              nb_cls=converter.num_classes)
    model = load_serving_model(args.checkpoint, cfg, args.device)
    if model.cfg.nb_cls != converter.num_classes:
        sys.exit(f"{args.checkpoint}: {model.cfg.nb_cls} classes, but the charset "
                 f"gives {converter.num_classes}")
    h, w = model.cfg.img_size
    if args.width_buckets:
        buckets = [int(x) for x in args.width_buckets.split(",") if x.strip()]
        widths = [natural_line_width(path, h) for path in paths]
    else:
        buckets, widths = [w], [w] * len(paths)
    t0 = time.perf_counter()
    # one batch of a bucket at a time: host memory stays at one batch
    texts = transcribe_buckets(
        model, lambda i, width: load_line_image(paths[i], width, h), widths,
        buckets, converter, args.batch_size)
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


if __name__ == "__main__":
    main()
