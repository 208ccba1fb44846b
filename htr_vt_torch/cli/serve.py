"""Batch serving with the PyTorch port (port of ``htr_vt_tpu/cli/serve.py``,
base width only): transcribe line images to JSONL, one
{"image", "text"} record per line.

    python -m htr_vt_torch.cli.serve IAM --checkpoint best_CER.pth \\
        --images 'scans/*.png' --batch-size 128 [--out preds.jsonl]

The checkpoint is a state_dict in the reference PyTorch layout (what
``htr_vt_tpu/utils/torch_convert.py`` reads and writes). Width buckets,
int8 and beam/LM rescoring are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from htr_vt_tpu.config import dataset_preset
from htr_vt_torch import CTCLabelConverter
from htr_vt_torch.models.htr_vt import build_model
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


def charset(dataset: str, train_list: Optional[str] = None,
            data_path: Optional[str] = None) -> List[str]:
    """The codec alphabet the JAX serve CLI derives: the sorted synthetic
    alphabet for SYNTH, else the sorted characters of the training list."""
    cfg = dataset_preset(dataset).data
    if cfg.dataset == "SYNTH":
        return sorted(set(cfg.synth_alphabet))
    from htr_vt_tpu.data.lists import LineIndex
    index = LineIndex.from_list_file(train_list or cfg.train_list,
                                     data_path or cfg.data_path,
                                     max_label_len=cfg.max_label_len)
    return index.alphabet


def _image_paths(spec: str) -> Sequence[str]:
    if os.path.isfile(spec) and not spec.endswith((".png", ".jpg")):
        with open(spec) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return sorted(glob.glob(spec))


def main(argv: Optional[Sequence[str]] = None) -> None:
    from htr_vt_tpu.data.image import load_line_image  # needs PIL

    p = argparse.ArgumentParser(description="htr_vt_torch batch transcription")
    p.add_argument("dataset", help="IAM | READ | LAM | SYNTH (sets the charset)")
    p.add_argument("--checkpoint", required=True,
                   help="state_dict in the reference PyTorch layout (.pth)")
    p.add_argument("--images", required=True,
                   help="glob pattern or file with one path per line")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--out", default=None, help="JSONL output (default stdout)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--train-list", default=None,
                   help="training list for the charset (default: the preset's)")
    p.add_argument("--data-path", default=None)
    args = p.parse_args(argv)

    paths = _image_paths(args.images)
    if not paths:
        sys.exit(f"no images match {args.images!r}")
    converter = CTCLabelConverter(charset(args.dataset, args.train_list,
                                          args.data_path))
    cfg = dataclasses.replace(dataset_preset(args.dataset).model,
                              nb_cls=converter.num_classes)
    model = build_model(cfg, device=torch.device(args.device))
    model.load_state_dict(load_reference_checkpoint(args.checkpoint),
                          strict=True)
    h, w = cfg.img_size
    t0 = time.perf_counter()
    sink = open(args.out, "w") if args.out else sys.stdout
    try:
        # one request at a time: host memory stays at one batch of images
        for start in range(0, len(paths), args.batch_size):
            chunk = paths[start:start + args.batch_size]
            images = np.stack([load_line_image(path, w, h) for path in chunk])
            for path, text in zip(chunk, transcribe(model, images, converter,
                                                    args.batch_size)):
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
