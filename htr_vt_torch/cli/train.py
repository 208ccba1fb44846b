"""Training entry point (port of ``htr_vt_tpu/cli/train.py``):
``python -m htr_vt_torch.cli.train [IAM|READ|LAM|SYNTH] <flags> [--device cpu]``.

One trainer for every recipe flag; the encoders and training features the
port does not have yet raise, naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Optional, Sequence

from htr_vt_torch.cli.args import args_to_config, build_parser
from htr_vt_torch.train.loop import fit


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser("htr_vt_torch trainer").parse_args(argv)
    cfg = args_to_config(args)
    result = fit(cfg, device=args.device)
    print(f"done: best CER {result['best_cer']:.4f} best WER {result['best_wer']:.4f}")


if __name__ == "__main__":
    main()
