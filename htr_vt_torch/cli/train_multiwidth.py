"""The multi-width training recipe (port of ``tools/train_multiwidth.py``):
one parameter set trained over several width buckets, so that the long
lines that width-bucketed serving (``cli/serve.py --width-buckets``) routes
to the 1024/2048-px buckets are lines the model has trained on.

    python -m htr_vt_torch.cli.train_multiwidth --iters 6000 --bs 64 \\
        --widths 512,1024,2048 --out output/multiwidth [--device cpu]

Each bucket holds SYNTH lines rendered at its width, with label lengths
sized to the canvas (``trim_to_canvas``, ``data/synthetic.py``), so the
wide buckets really hold long lines. The steps take the buckets in turn,
one batch of a bucket a step, each from its own loader; every
``--eval-every`` steps each bucket's validation lines are transcribed with
the EMA weights (CER, WER, ms an eval batch), and the checkpoint keeps the
best mean CER over the buckets (``best_CER``) and the eval history in its
meta. ``multiwidth_summary.json`` has the JAX tool's keys.

One ``TrainState`` serves every width: the port's model takes any width
(the sin-cos position table follows the image's grid, ``models/htr_vt.py:
pos_table``), where the JAX tool builds one ``HTRVT`` module and one
compiled program a width over one parameter set. ``main`` renders the
lines (cv2); ``run`` takes the buckets as datasets, so a machine without
cv2 trains on lines it has in memory, with the ``ExperimentConfig`` it is
given (the stem switches, the augmentation).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from htr_vt_torch.config import (ExperimentConfig, MaskConfig, ModelConfig, OptimConfig,
                                 TrainConfig, config_to_dict)
from htr_vt_torch.data.loader import TrainLoader, choose_max_label_len, eval_batches
from htr_vt_torch.text.converter import CTCLabelConverter
from htr_vt_torch.text.metrics import RecognitionMetrics
from htr_vt_torch.train.checkpoint import CheckpointManager
from htr_vt_torch.train.state import TrainState, create_train_state
from htr_vt_torch.train.step import eval_step, train_step
from htr_vt_torch.utils.logging import get_logger

LOG_EVERY = 200


def build_parser() -> argparse.ArgumentParser:
    """The JAX tool's flags and defaults, and ``--device``."""
    ap = argparse.ArgumentParser(description="htr_vt_torch multi-width training")
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--widths", type=str, default="512,1024,2048")
    ap.add_argument("--encoder", type=str, default="vit")
    ap.add_argument("--train-size", type=int, default=1024,
                    help="train lines PER BUCKET")
    ap.add_argument("--eval-size", type=int, default=256)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--max-lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", type=str, default="output/multiwidth")
    ap.add_argument("--embed-dim", type=int, default=768,
                    help="shrink for CPU smoke tests")
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--num-heads", type=int, default=6)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def len_range(w: int):
    """Characters a line of a ``w``-px bucket holds: ~28 fill 512 px at the
    renderer's glyph scale."""
    hi = max(6, int(28 * w / 512))
    return max(4, hi // 3), hi


def make_buckets(args) -> List[Dict]:
    """A train and a validation set of rendered SYNTH lines a width, at the
    JAX tool's seeds (cv2)."""
    from htr_vt_torch.data.synthetic import SyntheticLineDataset

    buckets = []
    for bi, w in enumerate(int(w) for w in args.widths.split(",")):
        lo, hi = len_range(w)
        train = SyntheticLineDataset(args.train_size, seed=args.seed + 10 * bi, width=w,
                                     min_len=lo, max_len=hi, trim_to_canvas=True)
        val = SyntheticLineDataset(args.eval_size, seed=args.seed + 10 * bi + 1, width=w,
                                   min_len=lo, max_len=hi, trim_to_canvas=True)
        buckets.append({"w": w, "train": train, "val": val})
    return buckets


def base_config(args, nb_cls: int = 0) -> ExperimentConfig:
    """The JAX tool's configuration: span masking, warm-up a tenth of the
    steps, weight decay 0.5."""
    return ExperimentConfig(
        model=ModelConfig(nb_cls=nb_cls or ModelConfig().nb_cls, encoder=args.encoder,
                          embed_dim=args.embed_dim, depth=args.depth,
                          num_heads=args.num_heads,
                          masking=MaskConfig(mode="span", ratio=0.4, max_span_length=8)),
        optim=OptimConfig(max_lr=args.max_lr, warmup_iters=args.iters // 10,
                          total_iters=args.iters, weight_decay=0.5),
        train=TrainConfig(out_dir=args.out, exp_name="", seed=args.seed))


def shared_converter(buckets: Sequence[Dict]) -> CTCLabelConverter:
    """The codec over every bucket's training alphabet."""
    return CTCLabelConverter(sorted(set().union(*[set(b["train"].alphabet)
                                                  for b in buckets])))


def prepare(buckets: List[Dict], cfg: ExperimentConfig, args,
            converter: CTCLabelConverter) -> None:
    """Each bucket's frame count, label length (``choose_max_label_len``)
    and loader, with the JAX tool's seeds (``args.seed + width``)."""
    for b in buckets:
        model = dataclasses.replace(cfg.model, img_size=(cfg.model.img_size[0], b["w"]))
        b["tokens"] = model.num_tokens
        b["max_label_len"] = choose_max_label_len(b["train"].labels, b["tokens"])
        b["loader"] = TrainLoader(b["train"], converter, args.bs, b["max_label_len"],
                                  augment=cfg.data.augment, seed=args.seed + b["w"],
                                  num_threads=4)


def evaluate(model: torch.nn.Module, buckets: Sequence[Dict],
             converter: CTCLabelConverter, bs: int) -> Dict[int, Dict[str, float]]:
    """Each bucket's CER, WER and ms an eval batch (host clock, the
    transcription of a batch read back included)."""
    out = {}
    for b in buckets:
        m = RecognitionMetrics()
        t0, nb = time.perf_counter(), 0
        for batch, valid, texts in eval_batches(b["val"], converter, bs, b["max_label_len"]):
            r = eval_step(model, batch)
            m.update(converter.decode_batch(r["pred_ids"][:valid].cpu().numpy()), texts)
            nb += 1
        out[b["w"]] = {"cer": m.cer, "wer": m.wer,
                       "eval_ms_per_batch": (time.perf_counter() - t0) / nb * 1e3}
    return out


def run(buckets: List[Dict], cfg: ExperimentConfig, args, device="cuda",
        state: Optional[TrainState] = None) -> Dict:
    """Train ``args.iters`` steps over ``buckets`` (dicts with ``w``, and
    ``train`` / ``val`` datasets with ``labels``, ``alphabet`` and
    ``__getitem__`` -> (uint8 [H, w] image, text)), taking them in turn.
    ``cfg``: the model, optimizer and data settings (``base_config``);
    ``nb_cls`` is set from the buckets' alphabet. ``state``: a state to
    train in place of a fresh one seeded with ``args.seed``. Writes the
    checkpoints and ``multiwidth_summary.json`` under ``args.out``;
    returns the summary."""
    widths = [b["w"] for b in buckets]
    os.makedirs(args.out, exist_ok=True)
    logger = get_logger(args.out)
    converter = shared_converter(buckets)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, nb_cls=converter.num_classes))
    prepare(buckets, cfg, args, converter)
    device = torch.device(device)
    if state is None:
        state = create_train_state(cfg, device,
                                   torch.Generator(device=device).manual_seed(args.seed))
    ckpt = CheckpointManager(args.out, keep=3)

    logger.info("multi-width training: widths=%s bs=%d iters=%d encoder=%s",
                widths, args.bs, args.iters, cfg.model.encoder)
    best, best_wer = 1e9, 1e9
    history: List[Dict] = []
    t0 = time.time()
    try:
        for it in range(args.iters):
            b = buckets[it % len(buckets)]
            metrics = train_step(state, next(b["loader"]))
            if (it + 1) % LOG_EVERY == 0:
                logger.info("iter %d loss %.4f (%.0f img/s)", it + 1, float(metrics["loss"]),
                            LOG_EVERY * args.bs / max(time.time() - t0, 1e-9))
                t0 = time.time()
            if (it + 1) % args.eval_every == 0 or it + 1 == args.iters:
                res = evaluate(state.ema_model, buckets, converter, args.bs)
                mean_cer = float(np.mean([r["cer"] for r in res.values()]))
                mean_wer = float(np.mean([r["wer"] for r in res.values()]))
                for w, r in res.items():
                    logger.info("iter %d width %d: CER %.4f WER %.4f (eval %.1f ms/batch)",
                                it + 1, w, r["cer"], r["wer"], r["eval_ms_per_batch"])
                history.append({"iter": it + 1,
                                **{str(w): {k: round(v, 4) for k, v in r.items()}
                                   for w, r in res.items()}})
                best, best_wer = min(best, mean_cer), min(best_wer, mean_wer)
                ckpt.save(state, cer=mean_cer, wer=mean_wer, best_cer=best,
                          best_wer=best_wer, meta={"widths": widths, "history": history,
                                                   "config": config_to_dict(cfg)})
    finally:
        for b in buckets:
            b["loader"].close()
    summary = {"widths": widths, "iters": args.iters, "bs": args.bs,
               "encoder": cfg.model.encoder, "final": history[-1], "history": history}
    with open(os.path.join(args.out, "multiwidth_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    logger.info("final: %s", json.dumps(history[-1]))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    return run(make_buckets(args), base_config(args), args, args.device)


if __name__ == "__main__":
    main()
