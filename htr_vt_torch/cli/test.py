"""Evaluation entry point (port of ``htr_vt_tpu/cli/test.py``):
``python -m htr_vt_torch.cli.test [DATASET] --checkpoint ... [--device cpu]``.

Reference behavior (model_v1/test.py): load the EMA weights, rebuild the
training alphabet, evaluate the test split, print CER/WER, and dump
``predictions.json`` with per-sample CER/WER. int8 evaluation is not ported
yet (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

from htr_vt_torch.cli.args import args_to_config, build_parser
from htr_vt_torch.data.loader import (build_dataset, choose_max_label_len,
                                      eval_batches, make_converter)
from htr_vt_torch.eval.validate import validate
from htr_vt_torch.text.metrics import per_sample_cer_wer
from htr_vt_torch.train.checkpoint import load_ema_model


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = build_parser("htr_vt_torch evaluator")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="checkpoint dir (rolling, best_CER/best_WER, or run dir)")
    parser.add_argument("--split", type=str, default="test", choices=["val", "test"])
    parser.add_argument("--predictions-out", type=str, default=None)
    args = parser.parse_args(argv)
    cfg = args_to_config(args)
    if cfg.model.quant != "none":
        raise NotImplementedError(
            f"--quant {cfg.model.quant}: int8 evaluation is not ported to htr_vt_torch "
            "yet (ROADMAP.md queue 1, item 11: int8 serving)")

    # Training alphabet defines the codec (reference test.py:43-45 reloads the
    # train split only to rebuild it).
    train_ds = build_dataset(cfg.data, "train")
    eval_ds = build_dataset(cfg.data, args.split)
    converter = make_converter(cfg.data, train_ds)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, nb_cls=converter.num_classes))
    max_label_len = choose_max_label_len(train_ds.labels, cfg.model.num_tokens)
    model = load_ema_model(args.checkpoint, cfg.model, args.device)

    loss, cer, wer, preds, labels = validate(
        model, eval_batches(eval_ds, converter, cfg.data.val_bs, max_label_len),
        converter)
    print(f"loss {loss:.4f}  CER {cer:.4f}  WER {wer:.4f}  ({len(preds)} samples)")

    out_path = args.predictions_out or os.path.join(
        cfg.train.out_dir, cfg.train.exp_name, "predictions.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    records = []
    for p, l in zip(preds, labels):
        scer, swer = per_sample_cer_wer(p, l)
        records.append({"prediction": p, "label": l, "cer": scer, "wer": swer})
    with open(out_path, "w") as f:
        json.dump({"CER": cer, "WER": wer, "loss": loss, "samples": records},
                  f, indent=2, ensure_ascii=False)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
