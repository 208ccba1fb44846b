"""The flagship's shapes, and its operations counted from them.

``stem_convs`` walks the ResNet18 stem of HTR-VT (``model/resnet18.py`` of
the published model, as the port's ``models/stem.py`` builds it): conv1 at
(2, 1), the entry max-pool at (2, 1), three stages of two BasicBlocks at
(2, 1), (2, 2), (2, 2), the final max-pool at (2, 1). An operation is a
multiply or an add: a product of an [m, k] and a [k, n] matrix is 2mkn.
Only the products are counted (convolutions, linears, attention), as model
FLOPs: no recomputation, no padding rows, no elementwise work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from htrbench import peaks

STAGE_STRIDES = ((2, 1), (2, 2), (2, 2))


@dataclass(frozen=True)
class Conv:
    """One convolution of the stem at its shape (one image)."""

    name: str
    cin: int
    cout: int
    k: int
    stride: Tuple[int, int]
    hin: int
    win: int

    @property
    def hout(self) -> int:
        pad = self.k // 2
        return (self.hin + 2 * pad - self.k) // self.stride[0] + 1

    @property
    def wout(self) -> int:
        pad = self.k // 2
        return (self.win + 2 * pad - self.k) // self.stride[1] + 1

    @property
    def flops(self) -> float:
        return 2.0 * self.k * self.k * self.cin * self.cout * self.hout * self.wout


def stem_convs(embed_dim: int, height: int, width: int,
               widths: Optional[Sequence[int]] = None) -> List[Conv]:
    """Every convolution of the stem, in order, with names
    ``conv1`` and ``layer{s}.{b}.conv1|conv2|proj``. ``widths`` (default
    D/4, D/2, D) are the stages' channels; conv1 is D/4 wide whatever they
    are."""
    c1 = embed_dim // 4
    widths = [c1, embed_dim // 2, embed_dim] if widths is None else list(widths)
    out = [Conv("conv1", 1, c1, 3, (2, 1), height, width)]
    h, w = out[0].hout // 2, out[0].wout  # the entry max-pool at (2, 1)
    cin = c1
    for s, (cout, stride) in enumerate(zip(widths, STAGE_STRIDES), start=1):
        first = Conv(f"layer{s}.0.conv1", cin, cout, 3, stride, h, w)
        ho, wo = first.hout, first.wout
        out += [first, Conv(f"layer{s}.0.conv2", cout, cout, 3, (1, 1), ho, wo)]
        if stride != (1, 1) or cin != cout:
            out.append(Conv(f"layer{s}.0.proj", cin, cout, 1, stride, h, w))
        out += [Conv(f"layer{s}.1.conv1", cout, cout, 3, (1, 1), ho, wo),
                Conv(f"layer{s}.1.conv2", cout, cout, 3, (1, 1), ho, wo)]
        h, w, cin = ho, wo, cout
    return out


def tokens(height: int, width: int) -> int:
    """Tokens a line gives: the stem's output is 1 x W/4 after the final
    max-pool (64 px high lines)."""
    convs = stem_convs(4, height, width)
    last = convs[-1]
    return ((last.hout - 1) // 2 + 1) * last.wout


def encoder_flops(n: int, d: int, depth: int, mlp_ratio: float, classes: int
                  ) -> Tuple[float, float]:
    """(linear, attention-core) operations of the ViT blocks and the head
    for one line of n tokens."""
    hidden = int(d * mlp_ratio)
    linear = depth * 2.0 * n * (d * 3 * d + d * d + 2 * d * hidden) + 2.0 * n * d * classes
    attn = depth * 2.0 * 2.0 * n * n * d
    return linear, attn


def forward_flops(cfg: dict, width: int) -> dict:
    """One line's forward operations at ``width`` by part: ``stem``,
    ``stem_entry`` (conv1, inside ``stem``), ``linear``, ``attn``, and
    ``total``. ``cfg`` is a configuration file's ``model`` object."""
    h = cfg["img_size"][0]
    d = cfg["embed_dim"]
    convs = stem_convs(d, h, width)
    stem = sum(c.flops for c in convs)
    linear, attn = encoder_flops(tokens(h, width), d, cfg["depth"], cfg["mlp_ratio"],
                                 cfg["nb_cls"])
    return dict(stem=stem, stem_entry=convs[0].flops, linear=linear, attn=attn,
                total=stem + linear + attn)


def train_step_flops(cfg: dict, width: int) -> float:
    """One image's operations in a SAM step: two passes, each a forward and
    a backward that takes twice the forward's products (the gradients of
    the input and of the weights), except the entry conv, whose input (the
    image) needs no gradient."""
    f = forward_flops(cfg, width)
    return 2.0 * (3.0 * f["total"] - f["stem_entry"])


def serve_peak_seconds(cfg: dict, width: int) -> float:
    """The least time one line's forward takes at the card's peaks, each
    operation at the peak of the type the configuration computes it in:
    int8 for the A8W8 sites (the blocks' convs and the encoder's linears),
    bf16 for the rest."""
    f = forward_flops(cfg, width)
    if cfg.get("quant") != "int8":
        return f["total"] / peaks.BF16_OPS_PER_S
    head = 2.0 * tokens(cfg["img_size"][0], width) * cfg["embed_dim"] * cfg["nb_cls"]
    int8_ops = (f["stem"] - f["stem_entry"]) + (f["linear"] - head)
    float_ops = f["stem_entry"] + head + f["attn"]
    return int8_ops / peaks.INT8_OPS_PER_S + float_ops / peaks.BF16_OPS_PER_S
