"""Closed-loop training: ``train/step.py:train_step`` back to back on a
pool of distinct device-resident batches made from the seed.

Set-up builds one ``TrainState`` (``train/state.py:create_train_state``)
with the benchmark's weights, and drives it through the traffic's
``reference_steps`` first steps on pool batches 0, 1, 2, ... through the
window's own call; those steps are the warm-up, and the reference follows
them once the window has closed. The same state goes on into the window.

Traffic parameters: ``batch``, ``width``, ``pool_batches``,
``label_lengths`` (a length mix, ``lines.mix_widths``' form read as
character counts), ``reference_steps`` and ``trace_steps`` (the steps a
traced run profiles after its window, behind one that warms the
profiler).
"""

from __future__ import annotations

import numpy as np
import torch

from htrbench import common, flops, kernels, lines, peaks, weights
from htrbench.common import Outcome, check, leaf_gap, sub_seed
from htrbench.reference.model import is_buffer, param_shapes
from htrbench.reference.numerics import Float32, tf32_off
from htrbench.reference.train import sam_steps
from htrbench.trace import Tracer, reduce

def label_lengths(params: dict):
    if "selftest" in params:
        return lines.selftest_lengths(**params["selftest"])
    return [int(params["fixed"])] * int(params["n"])


def make_pool(tr: dict, m: dict, seed: int, device) -> list:
    """``pool_batches`` batches of ``batch`` distinct lines at ``width``,
    labels of the mix's lengths over the model's classes."""
    rng = np.random.default_rng(sub_seed(seed, "data"))
    b, p, w = tr["batch"], tr["pool_batches"], tr["width"]
    mix = np.asarray(label_lengths(tr["label_lengths"]))
    lmax = int(mix.max())
    pool = []
    for _ in range(p):
        img = lines.line_images(b, rng, w, m["img_size"][0])
        lengths = rng.choice(mix, b).astype(np.int32)
        labels = rng.integers(1, m["nb_cls"], (b, lmax)).astype(np.int32)
        labels[np.arange(lmax)[None] >= lengths[:, None]] = 0
        pool.append({"image": torch.from_numpy(img).to(device),
                     "labels": torch.from_numpy(labels).to(device),
                     "label_lengths": torch.from_numpy(lengths).to(device)})
    return pool


def norms(tensors: dict, minus: dict | None = None) -> dict:
    return {k: float((v.float() - (minus[k].float() if minus else 0)).norm())
            for k, v in tensors.items()}


def build(cfg: dict, tr: dict, seed: int, device):
    """The benchmark's weights, one ``TrainState`` holding them (its mask
    generator seeded from ``seed``), the pool, and the mask seed."""
    from htr_vt_torch.train.state import create_train_state

    m = cfg["model"]
    exp = common.experiment_config(cfg)
    p0 = weights.make(param_shapes(m), sub_seed(seed, "weights"), device)
    state = create_train_state(exp, device, torch.Generator(device=device).manual_seed(0))
    state.model.load_state_dict(p0, strict=True)
    state.ema_model.load_state_dict(p0, strict=True)
    mask_seed = sub_seed(seed, "masks")
    state.generator.manual_seed(mask_seed)
    return p0, state, make_pool(tr, m, seed, device), mask_seed


def first_steps(state, pool, n: int, beta1: float, step=None) -> dict:
    """Drive ``state`` through ``n`` steps on pool batches 0..n-1 with
    ``step`` (the program's ``train_step``): each step's two losses, the
    logits of each of its forward passes (kept by a forward hook), the
    first gradient AdamW took (from its first moment after one step), and
    each parameter after the last step, with the EMA's."""
    if step is None:
        from htr_vt_torch.train.step import train_step as step
    named = dict(state.model.named_parameters())
    out = {"loss": [], "loss_second": [], "logits": []}
    hook = state.model.register_forward_hook(
        lambda module, args, output: out["logits"].append(output.detach().float().clone()))
    try:
        for k in range(n):
            res = step(state, pool[k])
            out["loss"].append(float(res["loss"]))
            out["loss_second"].append(float(res["loss_second"]))
            if k == 0:
                moments = {name: state.optimizer.state.get(p, {}).get("exp_avg")
                           for name, p in named.items()}
                out["first_grad"] = {name: (torch.zeros_like(p) if moments[name] is None
                                            else moments[name].float() / (1.0 - beta1))
                                     for name, p in named.items()}
    finally:
        hook.remove()
    out["params"] = {name: p.detach() for name, p in named.items()}
    out["ema"] = dict(state.ema_model.named_parameters())
    return out


def readings(steps: dict, params0: dict, keep_grad: bool = False) -> dict:
    """What the check compares: each step's two losses, the logits of each
    pass, the first gradient's norm by leaf, and the parameters' and the
    EMA's change from
    ``params0`` by leaf (tensors, normed in ``compare``); with
    ``keep_grad`` (the reference's) the first gradient itself."""
    def diff(now):  # kept on the host, so the card's peak stays the program's
        return {k: (now[k].float() - params0[k].float()).cpu() for k in params0}

    out = {"loss": list(zip(steps["loss"], steps["loss_second"])),
           "logits": [t.cpu() for t in steps["logits"]],
           "grad": norms(steps["first_grad"]),
           "change": diff(steps["params"]), "ema": diff(steps["ema"])}
    if keep_grad:
        out["first_grad_tensors"] = steps["first_grad"]
    return out


def reference(p0: dict, cfg: dict, batches: list, mask_seed: int, device,
              numerics=None) -> dict:
    """The reference's readings over the same first steps (float32, or
    ``numerics`` for a control)."""
    params0 = {k: v for k, v in p0.items() if not is_buffer(k)}
    with tf32_off():
        ref = sam_steps(p0, cfg["model"], cfg["optim"], batches,
                        torch.Generator(device=device).manual_seed(mask_seed),
                        numerics or Float32())
    return readings(ref, params0, keep_grad=True)


def moving(ref: dict) -> dict:
    """The elements of each leaf that the change is compared over: leaves
    whose reference gradient is under a thousandth of the median leaf's are
    left out, and within a leaf the elements whose reference gradient is
    under a thousandth of the leaf's root mean square (a key's bias under
    softmax has a gradient of round-off alone, and Adam moves it by the
    full step all the same, in a direction set by that round-off)."""
    med = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
    out = {}
    for k, g in ref["first_grad_tensors"].items():
        if ref["grad"][k] >= 1e-3 * med:
            rms = g.float().square().mean().sqrt()
            out[k] = (g.float().abs() >= 1e-3 * rms).cpu()
    return out


def change_norms(change: dict, masks: dict) -> dict:
    return {k: float(change[k][m].norm()) for k, m in masks.items()}


def logit_rms(prog: list, ref: list) -> float:
    """The worst pass's root mean square gap between the program's logits
    and the reference's (LayerNormed: 1 a frame); infinite where the passes
    or their shapes differ."""
    if len(prog) != len(ref) or any(p.shape != r.shape for p, r in zip(prog, ref)):
        return float("inf")
    return max(float((p - r).square().mean().sqrt()) for p, r in zip(prog, ref))


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """The five numbers: the worst relative gap of a step's loss, the worst
    pass's logit gap (``logit_rms``), and the worst leaf's gap of the first
    gradient's, the change's and the EMA's norms (``common.leaf_gap``), the
    change's and the EMA's over the elements that ``moving`` keeps."""
    masks = moving(ref)
    loss = max(abs(p - r) / abs(r) for pp, rr in zip(prog["loss"], ref["loss"])
               for p, r in zip(pp, rr))
    values = {"loss_gap": loss, "logit_rms": logit_rms(prog["logits"], ref["logits"]),
              "grad_gap": leaf_gap(prog["grad"], ref["grad"])}
    for part in ("change", "ema"):
        values[f"{part}_gap"] = leaf_gap(change_norms(prog[part], masks),
                                         change_norms(ref[part], masks))
    return {k: check(v, limits.get(k, float("inf"))) for k, v in values.items()}


def run(ctx) -> Outcome:
    from htr_vt_torch.train.step import train_step

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    m, o = cfg["model"], cfg["optim"]
    p0, state, pool, mask_seed = build(cfg, tr, ctx.seed, dev)
    params0 = {k: v for k, v in p0.items() if not is_buffer(k)}
    b, width, n_ref = tr["batch"], tr["width"], tr["reference_steps"]
    # set-up: the first steps, which the reference follows
    prog = readings(first_steps(state, pool, n_ref, o["beta1"], train_step), params0)
    common.sync(dev)
    setup_s = common.clock() - ctx.t_start

    # the window
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    steps, k = 0, n_ref
    t0 = common.clock()
    while common.clock() - t0 < ctx.seconds:
        train_step(state, pool[k % len(pool)])
        steps, k = steps + 1, k + 1
    common.sync(dev)
    window = common.clock() - t0
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    peak = max(peak, window_peak)

    record = dict(kind="train", cell=ctx.cell.name, model=m, window_s=window, steps=steps,
                  images=steps * b, unit_s=window / steps,
                  peak_seconds=steps * b * flops.train_step_flops(m, width) / peaks.BF16_OPS_PER_S,
                  window_peak_bytes=window_peak)
    if ctx.trace:  # after the window: one step to warm the profiler, then the traced steps
        tracer = Tracer(True)
        pos = [k]

        def unit():
            with tracer.span("train_step"):
                train_step(state, pool[pos[0] % len(pool)])
            pos[0] += 1

        n_tr = tr["trace_steps"]
        launches = tracer.trace(unit, n_tr, lambda: common.sync(dev), common.counters)
        red = reduce(tracer.events)
        red.update(units=n_tr, stretch_units=n_tr, launches=launches,
                   plans=[(kernels.plan(m, width, b, True), n_tr)])
        record["trace"] = red
    end_to_end = {"train_img_s": steps * b / window, "setup_s": setup_s}

    # the check: the reference follows the first steps from the same
    # weights, batches and mask draws, once the program's state is freed
    batches = pool[:n_ref]
    del state, pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(p0, cfg, batches, mask_seed, dev)
    return Outcome(attempted=steps, failed=0, end_to_end=end_to_end, record=record,
                   checks=compare(prog, ref, ctx.cell.limits), memory_peak_bytes=peak)
