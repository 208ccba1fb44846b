"""The recipe's training step in plain PyTorch: SAM around AdamW, then the
EMA (the reference ``model_v1/train.py`` with ``utils/sam.py`` and
``utils/utils.py``):

    pass 1   the mean CTC loss and its gradient g at w, masked, BN moved
    perturb  w + rho g / (||g|| + 1e-12), ||g|| over every parameter
    pass 2   the loss and its gradient g2 there, a fresh mask, BN moved
    AdamW    from w with g2 (decoupled decay lr * wd, then the moments'
             step), the learning rate warmup-cosine on the step count
    EMA      every tensor, decay min(0.9999, (1 + n) / (10 + n)), n = step / 2
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from htrbench.reference.model import forward, ctc_loss, is_buffer, span_keep


def warmup_cosine(step: int, o: dict) -> float:
    if step < o["warmup_iters"]:
        return o["max_lr"] * (step + 1.0) / (o["warmup_iters"] + 1.0)
    phase = math.pi * step / max(1, o["total_iters"] - o["warmup_iters"])
    return o["min_lr"] + (o["max_lr"] - o["min_lr"]) * 0.5 * (1.0 + math.cos(phase))


def sam_steps(state: Dict[str, torch.Tensor], m: dict, o: dict, batches: List[dict],
              generator: torch.Generator, num, step0: int = 0) -> dict:
    """Run one SAM step per batch from ``state`` (parameters and running
    statistics, float32, by name), drawing the masks from ``generator`` in
    the order the recipe draws them (pass 1, pass 2, each step). Returns
    the losses of both passes of each step (``loss``, ``loss_second``),
    the logits of each pass in that order (``logits``),
    the gradient AdamW took in the first step by parameter (``first_grad``),
    and the parameters and EMA after the last step (``params``, ``ema``)."""
    names = [k for k in state if not is_buffer(k)]
    params = {k: state[k].clone().requires_grad_(True) for k in names}
    stats = {k: state[k].clone() for k in state if is_buffer(k)}
    ema = {k: v.clone() for k, v in state.items()}
    exp_avg = {k: torch.zeros_like(v) for k, v in params.items()}
    exp_sq = {k: torch.zeros_like(v) for k, v in params.items()}
    mk = m["masking"]
    n_tok = None
    out = {"loss": [], "loss_second": [], "logits": []}

    def loss_and_grad(P, batch):
        nonlocal n_tok
        img = batch["image"]
        if n_tok is None:
            with torch.no_grad():
                n_tok = img.shape[2] // m["patch_size"][0]
        keep = span_keep(generator, img.shape[0], n_tok, mk["ratio"], mk["max_span_length"])
        logits = forward({**P, **stats}, m, img, num, train=True, keep=keep, stats=stats)
        out["logits"].append(logits.detach().float())
        loss = ctc_loss(logits, batch["labels"], batch["label_lengths"]).mean()
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        return loss.detach().float(), dict(zip(names, grads))

    for t, batch in enumerate(batches):
        step = step0 + t
        loss1, g1 = loss_and_grad(params, batch)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in g1.values()))
            scale = o["sam_rho"] / (gnorm + 1e-12)
            perturbed = {k: (params[k] + g1[k] * scale).requires_grad_(True) for k in names}
        del g1
        loss2, g2 = loss_and_grad(perturbed, batch)
        del perturbed
        lr = warmup_cosine(step, o)
        b1, b2 = o["beta1"], o["beta2"]
        with torch.no_grad():
            for k in names:
                p, g = params[k], g2[k].float()
                p.mul_(1.0 - lr * o["weight_decay"])
                exp_avg[k].mul_(b1).add_(g, alpha=1.0 - b1)
                exp_sq[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                c1, c2 = 1.0 - b1 ** (t + 1), 1.0 - b2 ** (t + 1)
                denom = exp_sq[k].sqrt() / math.sqrt(c2) + o["eps"]
                p.addcdiv_(exp_avg[k], denom, value=-lr / c1)
            if t == 0:
                out["first_grad"] = {k: v.detach().clone() for k, v in g2.items()}
            n = step / 2.0 if o.get("ema_halved_updates", True) else float(step)
            d = min(o["ema_decay"], (1.0 + n) / (10.0 + n))
            now = {**{k: params[k] for k in names}, **stats}
            for k in ema:
                ema[k].mul_(d).add_(now[k], alpha=1.0 - d)
        del g2
        out["loss"].append(float(loss1))
        out["loss_second"].append(float(loss2))
    out["params"] = {k: v.detach() for k, v in params.items()}
    out["ema"] = ema
    return out
