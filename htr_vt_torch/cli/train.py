"""Training entry point (port of ``htr_vt_tpu/cli/train.py``):
``python -m htr_vt_torch.cli.train [IAM|READ|LAM|SYNTH] <flags> [--device cpu]``.

One trainer for every recipe flag. ``--remat`` and ``--grad-accum`` are the
memory levers; several processes train data-parallel when launched with
``HTRVT_COORDINATOR`` (host:port of rank 0), ``HTRVT_NUM_PROCESSES`` and
``HTRVT_PROCESS_ID`` (NCCL with a card a rank, gloo on the CPU or where
ranks share cards), ``--train-bs`` and ``--val-bs`` being the global
batches (``train/loop.py:fit``).
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
