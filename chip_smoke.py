#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``htr_vt_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:

0. device: a CUDA device is required (there is no CPU path); prints the
   card's name and power limit as nvidia-smi gives them; TF32 off.
1. build: compiles ``htr_vt_torch/csrc/*.cu`` with nvcc for sm_90a into the
   git-ignored ``build/htr_vt_torch/``.
2. kernel vs plain: the CTC alpha kernel against ``ctc_alpha_reference``,
   the beta kernel against ``ctc_beta_reference``, the loss against the
   plain ``ctc_loss`` and ``d logits`` through both kernels against autograd
   through the plain loop, at the labelled train/eval shape (B=128, T=128,
   C=80, Lmax=96 -> S=193, with length-0 and infeasible rows) and the
   serving dummies (Lmax=8, all lengths 0 -> S=17), with CUDA-event times.
3. serve: the flagship ``ModelConfig()`` (64x512, embed 768, depth 4, heads
   6, 80 classes, bf16) with seeded random weights serves 3x128+37 line
   images through ``cli.serve.transcribe``, then runs one ``eval_step`` with
   real labels; the alpha kernel must launch once per ``eval_step`` and the
   beta kernel never. The same weights in float32 bound the bf16 error.
   Prints ms/batch, img/s and the peak device memory.
4. train: the flagship with the IAM recipe's span masking (ratio 0.4, max
   span 8) takes 2 warm-up and 10 timed SAM ``train_step``s at bs 128
   (labels of length 1-96, 8 of them infeasible); each step must launch the
   alpha and the beta kernel exactly twice. Then ``validate`` runs the EMA
   model over 2 batches (one alpha launch each, no beta), and a learning
   check trains 20 steps on one fixed batch of 16, whose pass-1 loss must
   fall. Prints ms/step, img/s, the peak device memory and CER/WER.

The second-to-last line is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from htr_vt_torch import (CTCLabelConverter, ExperimentConfig,  # noqa: E402
                          MaskConfig, ModelConfig, OptimConfig, _build)
from htr_vt_torch.cli.serve import transcribe  # noqa: E402
from htr_vt_torch.eval.validate import validate  # noqa: E402
from htr_vt_torch.models.htr_vt import build_model  # noqa: E402
from htr_vt_torch.ops import ctc_cuda  # noqa: E402
from htr_vt_torch.ops.ctc import NEG, ctc_loss  # noqa: E402
from htr_vt_torch.train.state import create_train_state  # noqa: E402
from htr_vt_torch.train.step import eval_step, train_step  # noqa: E402

SEED = 0
BATCH = 128
N_IMAGES = 3 * BATCH + 37  # four requests; the last one padded to 128
LMAX = 96  # labelled eval shape: S = 2*96+1 = 193
SERVE_LMAX = 8  # serve.py's dummy labels: S = 17
# Alpha/beta kernel vs plain: float32, the same expf/logf recursion; only
# the gather and the order of the three-way logaddexp terms may round apart.
ALPHA_RTOL, ALPHA_ATOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
# d logits through the kernels against the same backward glue over the
# plain recursions: only scatter_add_'s atomics sum the states of a class in
# another order.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# ... and against autograd through the plain loop, an independent route. The
# glue's posterior exp(alpha + beta - total) is a difference of float32
# numbers of the size of the loss (~860 here), so it carries a few ulps of
# |total| as absolute error (measured 4.2e-4 against float64 on the CPU,
# where autograd's own error is 4.9e-5); the bar scales with the loss.
POSTERIOR_ULPS = 16
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
VAL_ROWS = (BATCH, BATCH - 7)  # valid rows of the 2 validation batches
LEARN_BATCH, LEARN_STEPS = 16, 20
# bf16 vs float32 serving on the same weights: frame-argmax agreement floor.
MIN_ARGMAX_AGREEMENT = 0.99
SENTINEL = NEG / 10  # alpha entries below this are the unreachable mark


def posterior_atol(loss):
    return max(GRAD_ATOL, POSTERIOR_ULPS * 2.0**-24 * loss.abs().max().item())


def say(*parts):
    print(*parts, flush=True)


def median_ms(fn, reps, warmup=3):
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[device] {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")
    smi_line = smi.strip().splitlines()[0]
    say(smi_line)
    return smi_line


def phase_build():
    t0 = time.perf_counter()
    log = _build.build()
    seconds = time.perf_counter() - t0
    _build.library()
    for line in log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            say(f"[build] {line.strip()}")
    say(f"[build] nvcc sm_90a -> {os.path.relpath(_build.LIBRARY)} in "
        f"{seconds:.2f} s")
    return seconds


# ---------------------------------------------------------------------------
def ctc_case(seed, lmax, zero_lengths, device):
    """B=128, T=128, C=80 logits and labels. Labelled case: 8 rows of length
    0, and 8 rows of 96 identical labels, which need 191 > 128 frames and so
    cannot be aligned."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((BATCH, 128, 80))).astype(np.float32)
    labels = rng.integers(1, 80, (BATCH, lmax)).astype(np.int32)
    if zero_lengths:
        lengths = np.zeros(BATCH, np.int32)
    else:
        lengths = rng.integers(1, lmax + 1, BATCH).astype(np.int32)
        lengths[:8] = 0
        lengths[8:16] = lmax
        labels[8:16] = labels[8:16, :1]
    labels[np.arange(lmax)[None] >= lengths[:, None]] = 0
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return put(logits), put(labels), put(lengths)


def _hold(name, what, got, want):
    """Kernel cube vs plain cube: the same unreachable states, equal
    sentinels, finite entries within tolerance. Returns max |err|."""
    finite = want > SENTINEL
    if not torch.equal(got > SENTINEL, finite):
        raise AssertionError(f"[{name}] {what} kernel and plain disagree on "
                             "which states are reachable")
    if not torch.equal(got[~finite], want[~finite]):
        raise AssertionError(f"[{name}] {what} sentinel entries differ")
    torch.testing.assert_close(got[finite], want[finite], rtol=ALPHA_RTOL,
                               atol=ALPHA_ATOL)
    err = (got[finite] - want[finite]).abs()
    return err.max().item() if err.numel() else 0.0, int(finite.sum())


def _loss_grad(loss_fn, logits, labels, lengths):
    x = logits.clone().requires_grad_(True)
    loss = loss_fn(x, labels, lengths)
    loss.sum().backward()
    return loss.detach(), x.grad


def _glue_over_plain(logits, labels, lengths):
    """d logits of the summed loss from the kernels' backward glue run over
    the plain recursions (the same formula, no kernel)."""
    x = logits.clone().requires_grad_(True)
    logp = torch.log_softmax(x, dim=-1)
    z, noskip, valid, start2, endm = ctc_cuda.extended_masks(labels, lengths)
    lp = logp.detach().contiguous()
    alpha = ctc_cuda.ctc_alpha_reference(lp, z, noskip, valid, start2)
    total = ctc_cuda.logsumexp_masked(alpha[:, -1], endm)
    feasible = (-total < 1e29).float()
    beta = ctc_cuda.ctc_beta_reference(lp, z, noskip, valid, endm)
    dlogp = ctc_cuda.ctc_grad_logp(alpha, beta, total, z, feasible, lp.shape[-1])
    logp.backward(dlogp)
    return x.grad


def phase_kernels(device):
    results = {}
    for name, lmax, zero in (("S193", LMAX, False), ("S17", SERVE_LMAX, True)):
        logits, labels, lengths = ctc_case(SEED + lmax, lmax, zero, device)
        logp = torch.log_softmax(logits, dim=-1).contiguous()
        z, noskip, valid, start2, endm = ctc_cuda.extended_masks(labels, lengths)
        alpha_k = ctc_cuda.ctc_alpha(logp, z, noskip, valid, start2)
        beta_k = ctc_cuda.ctc_beta(logp, z, noskip, valid, endm)
        torch.cuda.synchronize()
        alpha_err, n_alpha = _hold(name, "alpha", alpha_k, ctc_cuda.ctc_alpha_reference(
            logp, z, noskip, valid, start2))
        beta_err, n_beta = _hold(name, "beta", beta_k, ctc_cuda.ctc_beta_reference(
            logp, z, noskip, valid, endm))
        loss_k, grad_k = _loss_grad(ctc_cuda.ctc_loss_cuda, logits, labels, lengths)
        loss_p, grad_p = _loss_grad(ctc_loss, logits, labels, lengths)
        torch.testing.assert_close(loss_k, loss_p, rtol=LOSS_RTOL, atol=0.0)
        loss_rel = ((loss_k - loss_p).abs() / loss_p.abs().clamp_min(1e-30)).max().item()
        if not torch.isfinite(grad_k).all():
            raise AssertionError(f"[{name}] non-finite kernel-path gradient")
        grad_g = _glue_over_plain(logits, labels, lengths)
        torch.testing.assert_close(grad_k, grad_g, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        glue_err = (grad_k - grad_g).abs().max().item()
        atol = posterior_atol(loss_p)
        torch.testing.assert_close(grad_k, grad_p, rtol=GRAD_RTOL, atol=atol)
        grad_err = (grad_k - grad_p).abs().max().item()
        infeasible = (loss_p == 0) & (lengths > 0)
        if (grad_k[infeasible] != 0).any() or (grad_p[infeasible] != 0).any():
            raise AssertionError(f"[{name}] an infeasible row has a gradient")
        n_zero = int((loss_p == 0).sum())
        times = dict(
            alpha_ms=median_ms(lambda: ctc_cuda.ctc_alpha(
                logp, z, noskip, valid, start2), 50),
            alpha_plain_ms=median_ms(lambda: ctc_cuda.ctc_alpha_reference(
                logp, z, noskip, valid, start2), 10),
            beta_ms=median_ms(lambda: ctc_cuda.ctc_beta(
                logp, z, noskip, valid, endm), 50),
            beta_plain_ms=median_ms(lambda: ctc_cuda.ctc_beta_reference(
                logp, z, noskip, valid, endm), 10),
            grad_ms=median_ms(lambda: _loss_grad(
                ctc_cuda.ctc_loss_cuda, logits, labels, lengths), 20),
            grad_plain_ms=median_ms(lambda: _loss_grad(
                ctc_loss, logits, labels, lengths), 5, warmup=1))
        s = z.shape[1]
        say(f"[kernel {name}] B=128 T=128 C=80 S={s}: alpha max|err| "
            f"{alpha_err:.3e} over {n_alpha} finite entries, beta max|err| "
            f"{beta_err:.3e} over {n_beta} (rtol {ALPHA_RTOL}, atol "
            f"{ALPHA_ATOL}); reachability and sentinels equal; loss max rel "
            f"err {loss_rel:.3e} (rtol {LOSS_RTOL}; {n_zero} zero losses); "
            f"d logits vs the glue over plain recursions max|err| "
            f"{glue_err:.3e} (rtol {GRAD_RTOL}, atol {GRAD_ATOL}), vs autograd "
            f"through the plain loop {grad_err:.3e} (rtol {GRAD_RTOL}, atol "
            f"{atol:.3e}); {int(infeasible.sum())} infeasible rows exactly 0")
        say(f"[kernel {name}] alpha {times['alpha_ms']:.4f} ms vs plain "
            f"{times['alpha_plain_ms']:.4f} ms; beta {times['beta_ms']:.4f} ms "
            f"vs plain {times['beta_plain_ms']:.4f} ms; loss + d logits "
            f"{times['grad_ms']:.4f} ms vs plain {times['grad_plain_ms']:.4f} ms")
        results[name] = dict(alpha_err=alpha_err, beta_err=beta_err,
                             grad_glue_err=glue_err, grad_err=grad_err, **times)
    return results


# ---------------------------------------------------------------------------
def line_images(n, rng):
    """[n, 64, 512, 1] float32 "handwriting": dark random strokes on white
    over a random-length stretch of a text band."""
    img = np.ones((n, 64, 512), np.float32)
    ink_len = rng.integers(64, 513, n)
    cols = np.arange(512)[None, None, :] < ink_len[:, None, None]
    rows = (np.arange(64) >= 16) & (np.arange(64) < 48)
    ink = (rng.random((n, 64, 512)) < 0.2) & cols & rows[None, :, None]
    img[ink] = rng.uniform(0.0, 0.4, int(ink.sum())).astype(np.float32)
    return img[..., None]


def phase_serve(device):
    cfg = ModelConfig()  # the flagship: 64x512, 768, depth 4, heads 6, 80 cls
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = build_model(cfg, device=device, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    # 79 characters + blank = the 80 classes of the flagship head
    alphabet = [chr(c) for c in range(33, 33 + cfg.nb_cls - 1)]
    converter = CTCLabelConverter(alphabet)
    assert converter.num_classes == cfg.nb_cls
    rng = np.random.default_rng(SEED)
    images = line_images(N_IMAGES, rng)
    labels = rng.integers(1, cfg.nb_cls, (BATCH, LMAX)).astype(np.int32)
    lengths = rng.integers(0, LMAX + 1, BATCH).astype(np.int32)
    labels[np.arange(LMAX)[None] >= lengths[:, None]] = 0
    test_batch = {"image": images[:BATCH], "labels": labels,
                  "label_lengths": lengths}
    say(f"[serve] HTRVT {cfg.img_size[0]}x{cfg.img_size[1]} embed "
        f"{cfg.embed_dim} depth {cfg.depth} heads {cfg.num_heads} classes "
        f"{cfg.nb_cls} {cfg.compute_dtype}: {n_params} parameters, seeded init")

    # --- the main path, counted ------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    n_steps = math.ceil(N_IMAGES / BATCH) + 1
    ctc_cuda.ctc_alpha.launches = ctc_cuda.ctc_beta.launches = 0
    t0 = time.perf_counter()
    texts = transcribe(model, images, converter, BATCH)
    out = eval_step(model, test_batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ctc_cuda.ctc_alpha.launches
    beta_launches = ctc_cuda.ctc_beta.launches
    peak = torch.cuda.max_memory_allocated()
    say(f"[serve] served {len(texts)} images in {math.ceil(N_IMAGES / BATCH)} "
        f"requests + 1 labelled eval_step in {wall:.3f} s (first call, "
        f"cuDNN autotune included); ctc_alpha launches {launches} for "
        f"{n_steps} eval_step calls, ctc_beta launches {beta_launches}")
    if launches != n_steps or beta_launches != 0:
        raise AssertionError(f"ctc_alpha launched {launches} times and "
                             f"ctc_beta {beta_launches} times for {n_steps} "
                             "eval_step calls")
    if len(texts) != N_IMAGES:
        raise AssertionError(f"{len(texts)} texts for {N_IMAGES} images")
    logits = out["logits"]
    if tuple(logits.shape) != (BATCH, 128, cfg.nb_cls) or logits.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
    for key in ("logits", "loss_per_sample", "loss"):
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"non-finite {key}")
    n_chars = sum(len(t) for t in texts)
    say(f"[serve] logits {tuple(logits.shape)} finite; loss {out['loss'].item():.4f}"
        f" ({int((out['loss_per_sample'] == 0).sum())} zero rows); "
        f"{n_chars} characters decoded; peak memory {peak / 2**20:.1f} MiB")

    # --- bf16 vs float32 on the same weights ------------------------------
    model32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                          device=device)
    model32.load_state_dict(model.state_dict(), strict=True)
    x = torch.from_numpy(images[:BATCH]).to(device)
    with torch.inference_mode():
        l16, l32 = model(x), model32(x)
    dmax = (l16 - l32).abs().max().item()
    agree = (l16.argmax(-1) == l32.argmax(-1)).float().mean().item()
    top2 = l32.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).median().item()
    say(f"[serve] bf16 vs f32 (TF32 off): max |dlogits| {dmax:.4f}, frame "
        f"argmax agreement {agree:.4%} (floor {MIN_ARGMAX_AGREEMENT:.0%}); "
        f"median f32 top-2 margin {margin:.4f}")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"bf16/f32 argmax agreement {agree:.4%} below "
                             f"{MIN_ARGMAX_AGREEMENT:.0%}")
    del model32, l32

    # --- steady-state serving speed at bs 128 -------------------------------
    x_batch = {"image": x, "labels": torch.zeros((BATCH, SERVE_LMAX), dtype=torch.int32,
                                                 device=device),
               "label_lengths": torch.zeros(BATCH, dtype=torch.int32, device=device)}
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: model(x), 10)
        ctc_ms = median_ms(lambda: ctc_cuda.ctc_loss_cuda(
            l16, x_batch["labels"], x_batch["label_lengths"]), 20)
    step_ms = median_ms(lambda: eval_step(model, x_batch), 10)
    full = images[:3 * BATCH]  # three full requests, after the warm ones
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    transcribe(model, full, converter, BATCH)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3 / 3
    say(f"[serve] bs {BATCH}: forward {fwd_ms:.3f} ms, CTC loss (dummy labels) "
        f"{ctc_ms:.3f} ms, eval_step {step_ms:.3f} ms "
        f"({BATCH / step_ms * 1e3:.1f} img/s, device-resident batch); "
        f"transcribe {serve_ms:.3f} ms/batch ({BATCH / serve_ms * 1e3:.1f} img/s, "
        f"host numpy in, text out)")
    return launches


# ---------------------------------------------------------------------------
def train_batch(n, cfg, rng, device, infeasible=0):
    """n line images, labels of length 1..96 (S = 193); the first
    ``infeasible`` rows carry 96 equal labels, which need 191 > 128
    frames."""
    labels = rng.integers(1, cfg.nb_cls, (n, LMAX)).astype(np.int32)
    lengths = rng.integers(1, LMAX + 1, n).astype(np.int32)
    lengths[:infeasible] = LMAX
    labels[:infeasible] = labels[:infeasible, :1]
    labels[np.arange(LMAX)[None] >= lengths[:, None]] = 0
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {"image": put(line_images(n, rng)), "labels": put(labels),
            "label_lengths": put(lengths)}


def phase_train(device):
    model_cfg = ModelConfig(masking=MaskConfig(mode="span", ratio=0.4,
                                               max_span_length=8))
    cfg = ExperimentConfig(model=model_cfg, optim=OptimConfig())
    state = create_train_state(cfg, device,
                               torch.Generator(device=device).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 2)
    batch = train_batch(BATCH, model_cfg, rng, device, infeasible=8)
    say(f"[train] HTRVT flagship {model_cfg.compute_dtype}, span masking "
        f"ratio 0.4 span 8, SAM rho {cfg.optim.sam_rho} + AdamW, bs {BATCH}, "
        f"labels of length 1-{LMAX} (8 infeasible)")

    # --- the main path, counted ------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP):
        train_step(state, batch)
    torch.cuda.synchronize()
    ctc_cuda.ctc_alpha.launches = ctc_cuda.ctc_beta.launches = 0
    times, metrics = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(train_step(state, batch))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = {"ctc_alpha": ctc_cuda.ctc_alpha.launches,
                "ctc_beta": ctc_cuda.ctc_beta.launches}
    peak = torch.cuda.max_memory_allocated()
    if launches != {"ctc_alpha": 2 * TRAIN_STEPS, "ctc_beta": 2 * TRAIN_STEPS}:
        raise AssertionError(f"{TRAIN_STEPS} train steps launched {launches}; "
                             "each must launch alpha and beta twice")
    values = {k: [m[k].item() for m in metrics] for k in metrics[0]}
    for k, v in values.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"non-finite {k}: {v}")
    ms = statistics.median(times)
    say(f"[train] {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: median "
        f"{ms:.3f} ms/step ({BATCH / ms * 1e3:.1f} img/s; min {min(times):.3f}, "
        f"max {max(times):.3f}), peak memory {peak / 2**20:.1f} MiB; "
        f"launches {launches} (2 + 2 per step)")
    say("[train] loss " + " ".join(f"{v:.3f}" for v in values["loss"])
        + "; loss_second " + " ".join(f"{v:.3f}" for v in values["loss_second"])
        + "; grad_norm " + " ".join(f"{v:.3f}" for v in values["grad_norm"]))

    # --- EMA validation: one alpha launch per batch, no beta --------------
    alphabet = [chr(c) for c in range(33, 33 + model_cfg.nb_cls - 1)]
    converter = CTCLabelConverter(alphabet)
    val = []
    for n_valid in VAL_ROWS:  # the last batch padded past its valid rows
        b = train_batch(BATCH, model_cfg, rng, device)
        labels, lengths = b["labels"].cpu().numpy(), b["label_lengths"].cpu().numpy()
        texts = ["".join(alphabet[c - 1] for c in row[:n])
                 for row, n in zip(labels[:n_valid], lengths[:n_valid])]
        val.append((b, n_valid, texts))
    ctc_cuda.ctc_alpha.launches = ctc_cuda.ctc_beta.launches = 0
    val_loss, cer, wer, preds, _ = validate(state.ema_model, val, converter)
    val_launches = {"ctc_alpha": ctc_cuda.ctc_alpha.launches,
                    "ctc_beta": ctc_cuda.ctc_beta.launches}
    if val_launches != {"ctc_alpha": len(VAL_ROWS), "ctc_beta": 0}:
        raise AssertionError(f"validate launched {val_launches} for "
                             f"{len(VAL_ROWS)} batches")
    if not math.isfinite(val_loss) or len(preds) != sum(VAL_ROWS):
        raise AssertionError(f"validate: loss {val_loss}, {len(preds)} predictions")
    say(f"[train] EMA validate over {len(VAL_ROWS)} batches ({len(preds)} valid "
        f"rows): loss {val_loss:.4f}, CER {cer:.4f}, WER {wer:.4f}; launches "
        f"{val_launches}")
    launches["ctc_alpha"] += val_launches["ctc_alpha"]

    # --- learning check ---------------------------------------------------
    learn = create_train_state(
        dataclasses.replace(cfg, optim=OptimConfig(max_lr=3e-4, warmup_iters=5)),
        device, torch.Generator(device=device).manual_seed(SEED + 3))
    small = train_batch(LEARN_BATCH, model_cfg, np.random.default_rng(SEED + 4),
                        device)
    losses = [train_step(learn, small)["loss"].item() for _ in range(LEARN_STEPS)]
    say(f"[train] learning check, {LEARN_STEPS} steps on one batch of "
        f"{LEARN_BATCH} (max_lr 3e-4, warmup 5): pass-1 loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"no learning: {losses}")
    return launches, dict(ms=ms, peak=peak)


# ---------------------------------------------------------------------------
def main():
    smi_line = phase_device()
    device = torch.device("cuda", 0)
    build_s = phase_build()
    kernels = phase_kernels(device)
    serve_launches = phase_serve(device)
    train_launches, _ = phase_train(device)
    say(f"[done] build {build_s:.2f} s; {smi_line}")
    k193, k17 = kernels["S193"], kernels["S17"]
    say(json.dumps({"kernels": [{
        "name": "ctc_alpha",
        "route": "cuda",
        "source": "htr_vt_torch/csrc/ctc_alpha.cu",
        "replaces": "htr_vt_tpu/ops/ctc_pallas.py:55",
        "launches": serve_launches + train_launches["ctc_alpha"],
        "launches_serve": serve_launches,
        "launches_train": train_launches["ctc_alpha"],
        "max_abs_err": max(k["alpha_err"] for k in kernels.values()),
        "ms": k193["alpha_ms"],
        "plain_ms": k193["alpha_plain_ms"],
        "shape": "B128 T128 C80 S193",
        "ms_s17": k17["alpha_ms"],
        "plain_ms_s17": k17["alpha_plain_ms"],
    }, {
        "name": "ctc_beta",
        "route": "cuda",
        "source": "htr_vt_torch/csrc/ctc_beta.cu",
        "replaces": "htr_vt_tpu/ops/ctc_pallas.py:88",
        "launches": train_launches["ctc_beta"],
        "max_abs_err": max(k["beta_err"] for k in kernels.values()),
        "ms": k193["beta_ms"],
        "plain_ms": k193["beta_plain_ms"],
        "shape": "B128 T128 C80 S193",
        "ms_s17": k17["beta_ms"],
        "plain_ms_s17": k17["beta_plain_ms"],
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
