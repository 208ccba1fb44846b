"""HTR-VT's forward and CTC loss in plain PyTorch, on a dict of float32
tensors named as the published model's state_dict.

    image [B, H, W, 1] in [0, 1] -> LayerNorm over the whole image (no
    parameters) -> ResNet18 stem -> tokens [B, N, D] -> (train) span mask
    with the learned mask token -> + the fixed 2-D sin-cos position table
    -> depth pre-norm ViT blocks -> LayerNorm -> head -> LayerNorm over
    the logits (no parameters) -> logits [B, N, classes]

BatchNorm in train mode normalises by the batch's mean and biased variance
and moves the running statistics by ``0.9 ra + 0.1 batch``; in eval it uses
the running statistics.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

STAGE_STRIDES = ((2, 1), (2, 2), (2, 2))
BN_EPS = 1e-5
BN_MOMENTUM = 0.9
STEM = "patch_embed"


def stage_widths(m: dict) -> List[int]:
    d = m["embed_dim"]
    return [d // 4, d // 2, d]


def blocks(m: dict) -> List[Tuple[str, int, int, Tuple[int, int], bool]]:
    """(prefix, cin, cout, stride, projection) of each stem block."""
    out, cin = [], m["embed_dim"] // 4
    for s, (cout, stride) in enumerate(zip(stage_widths(m), STAGE_STRIDES), start=1):
        proj = stride != (1, 1) or cin != cout
        out += [(f"{STEM}.layer{s}.0", cin, cout, stride, proj),
                (f"{STEM}.layer{s}.1", cout, cout, (1, 1), False)]
        cin = cout
    return out


def param_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the model by its published name: parameters, then
    BatchNorm running statistics (names ending ``running_mean`` /
    ``running_var``)."""
    d, c = m["embed_dim"], m["nb_cls"]
    c1 = d // 4
    hidden = int(d * m["mlp_ratio"])
    shapes: Dict[str, Tuple[int, ...]] = {"mask_token": (1, 1, d)}

    def bn(prefix, ch):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{k}"] = (ch,)

    shapes[f"{STEM}.conv1.weight"] = (c1, 1, 3, 3)
    bn(f"{STEM}.bn1", c1)
    for prefix, cin, cout, _, proj in blocks(m):
        shapes[f"{prefix}.conv1.weight"] = (cout, cin, 3, 3)
        bn(f"{prefix}.bn1", cout)
        shapes[f"{prefix}.conv2.weight"] = (cout, cout, 3, 3)
        bn(f"{prefix}.bn2", cout)
        if proj:
            shapes[f"{prefix}.downsample.0.weight"] = (cout, cin, 1, 1)
            bn(f"{prefix}.downsample.1", cout)
    for i in range(m["depth"]):
        p = f"blocks.{i}"
        shapes.update({
            f"{p}.norm1.weight": (d,), f"{p}.norm1.bias": (d,),
            f"{p}.attn.qkv.weight": (3 * d, d), f"{p}.attn.qkv.bias": (3 * d,),
            f"{p}.attn.proj.weight": (d, d), f"{p}.attn.proj.bias": (d,),
            f"{p}.norm2.weight": (d,), f"{p}.norm2.bias": (d,),
            f"{p}.mlp.fc1.weight": (hidden, d), f"{p}.mlp.fc1.bias": (hidden,),
            f"{p}.mlp.fc2.weight": (d, hidden), f"{p}.mlp.fc2.bias": (d,)})
    shapes.update({"norm.weight": (d,), "norm.bias": (d,), "head.weight": (c, d),
                   "head.bias": (c,)})
    return shapes


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def quant_sites(m: dict) -> Tuple[List[str], List[str]]:
    """(the A8W8 sites, the block outputs handed on as codes): every conv
    of the stem's blocks and every linear of the ViT blocks; each block's
    output but the last block's."""
    convs, emits = [], []
    bl = blocks(m)
    for i, (prefix, _, _, _, proj) in enumerate(bl):
        convs += [f"{prefix}.conv1", f"{prefix}.conv2"] + ([f"{prefix}.proj"] if proj else [])
        if i < len(bl) - 1:
            emits.append(f"{prefix}.out")
    for i in range(m["depth"]):
        convs += [f"blocks.{i}.attn.qkv", f"blocks.{i}.attn.proj",
                  f"blocks.{i}.mlp.fc1", f"blocks.{i}.mlp.fc2"]
    return convs, emits


def layer_norm_all(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over every non-batch dimension, no parameters."""
    dims = tuple(range(1, x.dim()))
    mean = x.mean(dims, keepdim=True)
    var = x.var(dims, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps)


def sincos_2d(d: int, grid: Tuple[int, int], device) -> torch.Tensor:
    """The fixed [gh * gw, d] sin-cos table of MAE (w-first meshgrid: the
    first half of each row encodes the column)."""
    gh, gw = grid
    gw_, gh_ = np.meshgrid(np.arange(gw, dtype=np.float64), np.arange(gh, dtype=np.float64))
    omega = 1.0 / 10000 ** (np.arange(d // 4, dtype=np.float64) / (d / 4.0))

    def emb(pos):
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    table = np.concatenate([emb(gw_), emb(gh_)], axis=1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def span_keep(generator: torch.Generator, batch: int, n: int, ratio: float,
              span: int) -> torch.Tensor:
    """The recipe's span mask, shared over the batch: ``int(n * ratio) //
    span`` spans of ``span`` tokens, starts uniform in [0, n - span),
    drawn from ``generator``; [B, n, 1], 1 = keep."""
    k = int(n * ratio) // max(1, span)
    if k <= 0 or ratio <= 0.0:
        return torch.ones((batch, n, 1), device=generator.device)
    starts = torch.randint(0, n - span, (k,), generator=generator, device=generator.device)
    pos = torch.arange(n, device=generator.device)[None, :]
    hit = ((pos >= starts[:, None]) & (pos < starts[:, None] + span)).any(0)
    return (1.0 - hit.float())[None, :, None].expand(batch, n, 1)


def _bn(P, prefix, x, train: bool, stats: Optional[dict]):
    w, b = P[f"{prefix}.weight"], P[f"{prefix}.bias"]
    if train:
        mean = x.mean((0, 2, 3))
        var = (x.square().mean((0, 2, 3)) - mean.square()).clamp_min(0.0)
        if stats is not None:
            m = BN_MOMENTUM
            stats[f"{prefix}.running_mean"] = (m * stats[f"{prefix}.running_mean"]
                                               + (1 - m) * mean.detach())
            stats[f"{prefix}.running_var"] = (m * stats[f"{prefix}.running_var"]
                                              + (1 - m) * var.detach())
    else:
        mean, var = P[f"{prefix}.running_mean"], P[f"{prefix}.running_var"]
    scale = w * torch.rsqrt(var + BN_EPS)
    return x * scale[None, :, None, None] + (b - mean * scale)[None, :, None, None]


def _pool(x):
    return F.max_pool2d(x, kernel_size=3, stride=(2, 1), padding=1)


def stem(P, m, x, num, train, stats):
    """[B, 1, H, W] -> [B, D, 1, W / 4]."""
    y = num.conv(x, P[f"{STEM}.conv1.weight"], (2, 1), 1, f"{STEM}.conv1")
    x = _pool(torch.relu(_bn(P, f"{STEM}.bn1", y, train, stats)))
    carried = False
    for prefix, _, _, stride, proj in blocks(m):
        y = num.conv(x, P[f"{prefix}.conv1.weight"], stride, 1, f"{prefix}.conv1", carried)
        a = torch.relu(_bn(P, f"{prefix}.bn1", y, train, stats))
        y = _bn(P, f"{prefix}.bn2",
                num.conv(a, P[f"{prefix}.conv2.weight"], (1, 1), 1, f"{prefix}.conv2"),
                train, stats)
        if proj:
            r = num.conv(x, P[f"{prefix}.downsample.0.weight"], stride, 0,
                         f"{prefix}.proj", carried)
            r = _bn(P, f"{prefix}.downsample.1", r, train, stats)
        else:
            r = x
        x, carried = num.emit(torch.relu(y + r), f"{prefix}.out")
    return _pool(x)


def _gelu(x, kind: str):
    return x * torch.sigmoid(1.702 * x) if kind == "quick" else F.gelu(x)


def encoder_block(P, m, i, x, num, gelu: str):
    p = f"blocks.{i}"
    b, n, d = x.shape
    heads = m["num_heads"]
    hd = d // heads
    eps = m.get("layer_norm_eps", 1e-6)
    h = F.layer_norm(x, (d,), P[f"{p}.norm1.weight"], P[f"{p}.norm1.bias"], eps)
    qkv = num.linear(h, P[f"{p}.attn.qkv.weight"], P[f"{p}.attn.qkv.bias"], f"{p}.attn.qkv")
    q, k, v = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    att = torch.softmax(num.matmul(q, k.transpose(-1, -2), f"{p}.attn.scores") / math.sqrt(hd), -1)
    o = num.matmul(att, v, f"{p}.attn.values").transpose(1, 2).reshape(b, n, d)
    x = x + num.linear(o, P[f"{p}.attn.proj.weight"], P[f"{p}.attn.proj.bias"], f"{p}.attn.proj")
    h = F.layer_norm(x, (d,), P[f"{p}.norm2.weight"], P[f"{p}.norm2.bias"], eps)
    h = _gelu(num.linear(h, P[f"{p}.mlp.fc1.weight"], P[f"{p}.mlp.fc1.bias"], f"{p}.mlp.fc1"),
              gelu)
    return x + num.linear(h, P[f"{p}.mlp.fc2.weight"], P[f"{p}.mlp.fc2.bias"], f"{p}.mlp.fc2")


def forward(P: Dict[str, torch.Tensor], m: dict, image: torch.Tensor, num, *,
            train: bool = False, keep: Optional[torch.Tensor] = None,
            stats: Optional[dict] = None) -> torch.Tensor:
    """Logits [B, N, classes] float32 of ``image`` [B, H, W, 1]. ``train``:
    batch statistics (moving ``stats`` in place when given) and the keep
    mask ``keep`` [B, N, 1]."""
    x = layer_norm_all(image.float()).permute(0, 3, 1, 2)
    x = stem(P, m, x, num, train, stats)
    b, d = x.shape[0], x.shape[1]
    tok = x.permute(0, 2, 3, 1).reshape(b, -1, d)
    n = tok.shape[1]
    if train and keep is not None:
        tok = tok * keep + (1.0 - keep) * P["mask_token"]
    h, w = image.shape[1], image.shape[2]
    pw, ph = m["patch_size"]
    tok = tok + sincos_2d(d, (h // pw, w // ph), tok.device)[:n]
    gelu = m.get("quant_gelu", "exact") if m.get("quant") == "int8" else "exact"
    for i in range(m["depth"]):
        tok = encoder_block(P, m, i, tok, num, gelu)
    feats = F.layer_norm(tok, (d,), P["norm.weight"], P["norm.bias"],
                         m.get("layer_norm_eps", 1e-6))
    return layer_norm_all(F.linear(feats, P["head.weight"], P["head.bias"]))


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-line CTC negative log-likelihood over all frames (blank 0, zero
    for a label no alignment produces), computed in float64."""
    logp = torch.log_softmax(logits.double(), -1).transpose(0, 1)
    t = torch.full((logits.shape[0],), logits.shape[1], dtype=torch.long,
                   device=logits.device)
    return F.ctc_loss(logp, labels.long(), t, lengths.long(), blank=0,
                      reduction="none", zero_infinity=True)
