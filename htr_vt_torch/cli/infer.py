"""Single-image quick inference (port of ``htr_vt_tpu/cli/infer.py``).

Mirrors model_window/quick_inference.py: load EMA weights from a checkpoint,
preprocess one line image (aspect resize + pad, optional binarization
threshold sweep), greedy-decode, print the text. Usage:

    python -m htr_vt_torch.cli.infer SYNTH --checkpoint <dir> --image line.png

``--quant int8`` serves the A8W8 model, its static scales calibrated on
the input image itself (``htr_vt_tpu/cli/infer.py:74-80``).
``--llm-correct MODEL`` also prints each variant corrected by the masked-LM
word corrector (``decode/lm.py:RobertaCorrector``, ``infer.py:84-100``):
words outside the training labels' vocabulary are masked and refilled where
the model is confident. It needs ``transformers`` and locally available
weights; without them it says so and prints the uncorrected lines.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from htr_vt_torch.cli.args import args_to_config, build_parser
from htr_vt_torch.data.image import prepare_line_image
from htr_vt_torch.data.loader import build_dataset, make_converter
from htr_vt_torch.ops.quant import calibrate_quant_stats
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
                        help="local path/name of a masked-LM for word correction"
                             " (quick_inference_llm.py equivalent; requires"
                             " transformers + locally available weights)")
    args = parser.parse_args(argv)
    cfg = args_to_config(args)
    if cfg.model.model_type == "encoder_decoder":
        raise NotImplementedError(
            "--model-type encoder_decoder: this entry point runs the CTC eval_step, "
            "which an encoder-decoder cannot take (neither can the JAX package's); "
            "fit validates an encoder-decoder with train/step.py:eval_step_ed")

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
    if cfg.model.quant == "int8":
        # single-image inference has no separate calibration stream
        calibrate_quant_stats(model, [variants[0][1][None]], 1)

    corrector, vocabulary = None, None
    if args.llm_correct:
        try:
            from htr_vt_torch.decode.lm import RobertaCorrector
            corrector = RobertaCorrector(args.llm_correct)
            vocabulary = {w.lower() for t in train_ds.labels for w in t.split()}
        except Exception as e:  # zero-egress deployments have no weights
            print(f"(LLM correction unavailable: {e})")

    for name, img in variants:
        batch = {"image": img[None],
                 "labels": np.zeros((1, 8), np.int32),
                 "label_lengths": np.zeros((1,), np.int32)}
        out = eval_step(model, batch)
        text = converter.decode_batch(out["pred_ids"].cpu().numpy())[0]
        print(f"[{name}] {text}")
        if corrector is not None:
            print(f"[{name}+llm] {corrector.correct(text, vocabulary)}")


if __name__ == "__main__":
    main()
