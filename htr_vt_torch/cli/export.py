"""Export a trained checkpoint as a ``torch.export`` serving bundle (port of
``htr_vt_tpu/cli/export.py``).

    python -m htr_vt_torch.cli.export IAM --checkpoint out/iam/best_CER \\
        --out out/iam/bundle [--width-buckets 512,1024,2048] [--quant int8] \\
        [--batch-size 64] [--verify] [--device cpu]

The bundle (``htr_vt_torch/deploy.py``) holds the EMA weights and one
exported program a serving width; loading it needs torch, numpy and the op
library only, no model code. ``--device`` (JAX's ``--platforms``) is the
device the programs are exported on and run on: ``cuda`` (the default) puts
the hand-written kernels into them as ``htrvt::`` ops, ``cpu`` their plain
twins. With ``--quant int8`` the activation scales are calibrated first,
over ``--calib-batches`` eval batches at the training width (as
``cli/test.py`` does); per-tensor scales do not depend on the width, so the
wider buckets reuse them. ``--verify`` reloads each program and requires
its ids and lengths bit-equal to the live model's on random input.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from htr_vt_torch.cli.args import args_to_config, build_parser
from htr_vt_torch.data.loader import (build_dataset, choose_max_label_len,
                                      eval_batches, make_converter)
from htr_vt_torch.deploy import (ServingBundle, export_serving, make_serving_fn,
                                 save_bundle)
from htr_vt_torch.ops.quant import calibrate_quant_stats
from htr_vt_torch.train.checkpoint import load_ema_model


def bucket_widths(spec: Optional[str], stride: int, base: int) -> List[int]:
    """The serving widths of ``--width-buckets`` (comma-separated), each
    rounded up to a multiple of the stem's width stride; the training width
    when none is given."""
    if not spec:
        return [base]
    return sorted({-(-int(w) // stride) * stride for w in spec.split(",") if w.strip()})


def verify_bundle(bundle: ServingBundle, model, widths: Sequence[int],
                  seed: int = 0) -> bool:
    """Each width's program against the live model on random input: True
    when ids and lengths are bit-equal at every width. Prints a line a
    width."""
    rng = np.random.default_rng(seed)
    device = next(model.parameters()).device
    live = make_serving_fn(model)
    ok_all = True
    for width in widths:
        img = rng.standard_normal((bundle.batch_size, bundle.height, width, 1)
                                  ).astype(np.float32)
        ids, lengths = bundle.run(img, width)
        with torch.no_grad():
            ref_ids, ref_len = live(torch.from_numpy(img).to(device))
        ok = (np.array_equal(ids, ref_ids.cpu().numpy())
              and np.array_equal(lengths, ref_len.cpu().numpy()))
        print(f"verify width {width}: "
              f"{'OK (bit-exact vs live model)' if ok else 'MISMATCH'}")
        ok_all &= ok
    return ok_all


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = build_parser("htr_vt_torch torch.export serving export")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--out", type=str, required=True,
                        help="bundle output directory")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--width-buckets", type=str, default=None,
                        help="comma-separated serving widths; default: the "
                             "training width (off-multiples round up like "
                             "cli/serve.py)")
    parser.add_argument("--calib-batches", type=int, default=4)
    parser.add_argument("--verify", action="store_true",
                        help="reload each program and check it matches the "
                             "live model on random input")
    args = parser.parse_args(argv)
    cfg = args_to_config(args)
    if cfg.model.model_type == "encoder_decoder":
        raise NotImplementedError(
            "--model-type encoder_decoder: the serving program is the CTC forward "
            "and greedy collapse, which an encoder-decoder cannot take (neither can "
            "the JAX package's export); its generation runs eagerly, "
            "models/encoder_decoder.py:generate")

    train_ds = build_dataset(cfg.data, "train")
    converter = make_converter(cfg.data, train_ds)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, nb_cls=converter.num_classes))
    device = torch.device(args.device)
    model = load_ema_model(args.checkpoint, cfg.model, device)
    bs = args.batch_size
    h, base_w = cfg.model.img_size
    widths = bucket_widths(args.width_buckets, cfg.model.patch_size[0], base_w)
    quant = "int8" if cfg.model.quant == "int8" else "float"
    if quant == "int8":
        eval_ds = build_dataset(cfg.data, "val")
        max_len = choose_max_label_len(train_ds.labels, cfg.model.num_tokens)
        calibrate_quant_stats(model, (b["image"] for b, _, _ in eval_batches(
            eval_ds, converter, bs, max_len)), args.calib_batches)

    programs = {}
    for width in widths:
        print(f"exporting width {width} (bs {bs}, quant {quant}, {device.type}) ...")
        programs[width] = export_serving(model, bs, (h, width))
    total = save_bundle(args.out, programs, {
        "charset": converter.character,
        "height": h,
        "batch_size": bs,
        "quant": quant,
        "checkpoint": os.path.abspath(args.checkpoint),
        "encoder": cfg.model.encoder,
        "device": device.type,
    })
    print(f"bundle written to {args.out} "
          f"({len(programs)} program(s), {total / 1e6:.1f} MB)")

    if args.verify and not verify_bundle(ServingBundle(args.out), model, widths):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
