"""Parameter-count audit on the port's model (port of
``htr_vt_tpu/cli/params.py``): per-module breakdown of a config.

Counterpart of the reference's audit tool (model_lgp/print_params.py:16-30).

    python -m htr_vt_torch.cli.params IAM [--depth-level 2] [--device cpu]

Modules are named as the port names them (the reference state_dict's
names: ``patch_embed.layer1``, ``blocks.0``, ...); ``--depth-level`` counts
dotted components.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional, Sequence

from htr_vt_torch.cli.args import args_to_config, build_parser
from htr_vt_torch.models.htr_vt import build_model


def parameter_groups(model, depth_level: int):
    """({module path cut to ``depth_level`` components: parameter count},
    total) over the model's parameters."""
    groups = defaultdict(int)
    total = 0
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[:depth_level])
        groups[key] += p.numel()
        total += p.numel()
    return dict(groups), total


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = build_parser("htr_vt_torch parameter audit")
    parser.add_argument("--depth-level", type=int, default=2,
                        help="module-path depth to aggregate at")
    args = parser.parse_args(argv)
    cfg = args_to_config(args).model
    groups, total = parameter_groups(build_model(cfg, device=args.device),
                                     args.depth_level)

    width = max(len(k) for k in groups)
    for key in sorted(groups, key=groups.get, reverse=True):
        n = groups[key]
        print(f"{key:<{width}}  {n:>12,}  ({100.0 * n / total:5.2f}%)")
    print("-" * (width + 24))
    print(f"{'total':<{width}}  {total:>12,}")


if __name__ == "__main__":
    main()
