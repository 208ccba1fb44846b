"""Single-image quick inference (port of ``htr_vt_tpu/cli/infer.py``).

Mirrors model_window/quick_inference.py: load EMA weights from a checkpoint,
preprocess one line image (aspect resize + pad, optional binarization
threshold sweep), greedy-decode, print the text. Usage:

    python -m htr_vt_torch.cli.infer SYNTH --checkpoint <dir> --image line.png

The masked-LM word corrector (``--llm-correct``) is not ported yet
(ROADMAP.md queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from htr_vt_torch.cli.args import args_to_config, build_parser
from htr_vt_torch.data.image import prepare_line_image
from htr_vt_torch.data.loader import build_dataset, make_converter
from htr_vt_torch.train.checkpoint import load_ema_model
from htr_vt_torch.train.step import eval_step


def binarize(img: np.ndarray, threshold: float) -> np.ndarray:
    return (img > threshold).astype(np.float32)


def main(argv: Optional[Sequence[str]] = None) -> None:
    from PIL import Image

    parser = build_parser("htr_vt_torch quick inference")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--image", type=str, required=True)
    parser.add_argument("--binarize-sweep", action="store_true", default=False,
                        help="try several binarization thresholds and report each"
                             " (quick_inference.py threshold sweep)")
    parser.add_argument("--llm-correct", type=str, default=None, metavar="MODEL",
                        help="masked-LM word correction (not ported yet: raises, "
                             "ROADMAP.md queue 1, item 14)")
    args = parser.parse_args(argv)
    cfg = args_to_config(args)
    if args.llm_correct:
        raise NotImplementedError(
            "--llm-correct: the RoBERTa corrector is not ported to htr_vt_torch yet "
            "(ROADMAP.md queue 1, item 14: deploy and serve)")
    if cfg.model.quant != "none":
        raise NotImplementedError(
            f"--quant {cfg.model.quant}: int8 inference is not ported to htr_vt_torch "
            "yet (ROADMAP.md queue 1, item 11: int8 serving)")

    train_ds = build_dataset(cfg.data, "train")
    converter = make_converter(cfg.data, train_ds)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, nb_cls=converter.num_classes))
    model = load_ema_model(args.checkpoint, cfg.model, args.device)

    raw = np.array(Image.open(args.image).convert("L"))
    h, w = cfg.model.img_size
    variants = [("raw", prepare_line_image(raw, w, h))]
    if args.binarize_sweep:
        for th in (0.3, 0.4, 0.5, 0.6, 0.7):
            variants.append((f"bin@{th}", binarize(prepare_line_image(raw, w, h), th)))

    for name, img in variants:
        batch = {"image": img[None],
                 "labels": np.zeros((1, 8), np.int32),
                 "label_lengths": np.zeros((1,), np.int32)}
        out = eval_step(model, batch)
        text = converter.decode_batch(out["pred_ids"].cpu().numpy())[0]
        print(f"[{name}] {text}")


if __name__ == "__main__":
    main()
