#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``htr_vt_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:

0. device: a CUDA device is required (there is no CPU path); prints the
   card's name and power limit as nvidia-smi gives them; TF32 off.
1. build: compiles ``htr_vt_torch/csrc/*.cu`` with nvcc for sm_90a into the
   git-ignored ``build/htr_vt_torch/``.
2. kernel vs plain: the CTC alpha kernel against ``ctc_alpha_reference``
   and its loss against the plain ``ctc_loss``, at the labelled eval shape
   (B=128, T=128, C=80, Lmax=96 -> S=193) and the serving dummies (Lmax=8,
   all lengths 0 -> S=17), with CUDA-event times of both.
3. slice: the flagship ``ModelConfig()`` (64x512, embed 768, depth 4, heads
   6, 80 classes, bf16) with seeded random weights serves 3x128+37 line
   images through ``cli.serve.transcribe``, then runs one ``eval_step`` with
   real labels; the CTC kernel must launch once per ``eval_step``. The same
   weights in float32 bound the bf16 error. Prints ms/batch, img/s and the
   peak device memory.

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

from htr_vt_torch import CTCLabelConverter, ModelConfig, _build  # noqa: E402
from htr_vt_torch.cli.serve import transcribe  # noqa: E402
from htr_vt_torch.models.htr_vt import build_model  # noqa: E402
from htr_vt_torch.ops import ctc_cuda  # noqa: E402
from htr_vt_torch.ops.ctc import NEG, ctc_loss  # noqa: E402
from htr_vt_torch.train.step import eval_step  # noqa: E402

SEED = 0
BATCH = 128
N_IMAGES = 3 * BATCH + 37  # four requests; the last one padded to 128
LMAX = 96  # labelled eval shape: S = 2*96+1 = 193
SERVE_LMAX = 8  # serve.py's dummy labels: S = 17
# Alpha kernel vs plain: float32, the same expf/logf recursion; only the
# gather and the order of the three-way logaddexp terms may round apart.
ALPHA_RTOL, ALPHA_ATOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
# bf16 vs float32 serving on the same weights: frame-argmax agreement floor.
MIN_ARGMAX_AGREEMENT = 0.99
SENTINEL = NEG / 10  # alpha entries below this are the unreachable mark


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


def phase_kernels(device):
    results = {}
    for name, lmax, zero in (("S193", LMAX, False), ("S17", SERVE_LMAX, True)):
        logits, labels, lengths = ctc_case(SEED + lmax, lmax, zero, device)
        logp = torch.log_softmax(logits, dim=-1).contiguous()
        z, noskip, valid, start2, _ = ctc_cuda.extended_masks(labels, lengths)
        alpha_k = ctc_cuda.ctc_alpha(logp, z, noskip, valid, start2)
        torch.cuda.synchronize()
        alpha_p = ctc_cuda.ctc_alpha_reference(logp, z, noskip, valid, start2)
        finite = alpha_p > SENTINEL
        if not torch.equal(alpha_k > SENTINEL, finite):
            raise AssertionError(f"[{name}] kernel and plain disagree on which "
                                 "alpha states are reachable")
        if not torch.equal(alpha_k[~finite], alpha_p[~finite]):
            raise AssertionError(f"[{name}] sentinel entries differ")
        err = (alpha_k[finite] - alpha_p[finite]).abs()
        max_abs = err.max().item() if err.numel() else 0.0
        torch.testing.assert_close(alpha_k[finite], alpha_p[finite],
                                   rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
        loss_k = ctc_cuda.ctc_loss_cuda(logits, labels, lengths)
        loss_p = ctc_loss(logits, labels, lengths)
        torch.testing.assert_close(loss_k, loss_p, rtol=LOSS_RTOL, atol=0.0)
        loss_rel = ((loss_k - loss_p).abs() / loss_p.abs().clamp_min(1e-30)).max().item()
        n_zero = int((loss_p == 0).sum())
        ms_k = median_ms(lambda: ctc_cuda.ctc_alpha(logp, z, noskip, valid, start2), 50)
        ms_p = median_ms(lambda: ctc_cuda.ctc_alpha_reference(
            logp, z, noskip, valid, start2), 10)
        s = z.shape[1]
        say(f"[kernel {name}] B=128 T=128 C=80 S={s}: alpha max|err| {max_abs:.3e}"
            f" over {int(finite.sum())} finite entries (rtol {ALPHA_RTOL}, atol "
            f"{ALPHA_ATOL}); sentinels equal; loss max rel err {loss_rel:.3e} "
            f"(rtol {LOSS_RTOL}; {n_zero} zero losses); kernel {ms_k:.4f} ms, "
            f"plain {ms_p:.4f} ms")
        results[name] = dict(max_abs_err=max_abs, ms=ms_k, plain_ms=ms_p)
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


def phase_slice(device):
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
    say(f"[slice] HTRVT {cfg.img_size[0]}x{cfg.img_size[1]} embed "
        f"{cfg.embed_dim} depth {cfg.depth} heads {cfg.num_heads} classes "
        f"{cfg.nb_cls} {cfg.compute_dtype}: {n_params} parameters, seeded init")

    # --- the main path, counted ------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    n_steps = math.ceil(N_IMAGES / BATCH) + 1
    ctc_cuda.ctc_alpha.launches = 0
    t0 = time.perf_counter()
    texts = transcribe(model, images, converter, BATCH)
    out = eval_step(model, test_batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ctc_cuda.ctc_alpha.launches
    peak = torch.cuda.max_memory_allocated()
    say(f"[slice] served {len(texts)} images in {math.ceil(N_IMAGES / BATCH)} "
        f"requests + 1 labelled eval_step in {wall:.3f} s (first call, "
        f"cuDNN autotune included); ctc_alpha launches {launches} for "
        f"{n_steps} eval_step calls")
    if launches != n_steps:
        raise AssertionError(f"ctc_alpha launched {launches} times for "
                             f"{n_steps} eval_step calls")
    if len(texts) != N_IMAGES:
        raise AssertionError(f"{len(texts)} texts for {N_IMAGES} images")
    logits = out["logits"]
    if tuple(logits.shape) != (BATCH, 128, cfg.nb_cls) or logits.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
    for key in ("logits", "loss_per_sample", "loss"):
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"non-finite {key}")
    n_chars = sum(len(t) for t in texts)
    say(f"[slice] logits {tuple(logits.shape)} finite; loss {out['loss'].item():.4f}"
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
    say(f"[slice] bf16 vs f32 (TF32 off): max |dlogits| {dmax:.4f}, frame "
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
    say(f"[slice] bs {BATCH}: forward {fwd_ms:.3f} ms, CTC loss (dummy labels) "
        f"{ctc_ms:.3f} ms, eval_step {step_ms:.3f} ms "
        f"({BATCH / step_ms * 1e3:.1f} img/s, device-resident batch); "
        f"transcribe {serve_ms:.3f} ms/batch ({BATCH / serve_ms * 1e3:.1f} img/s, "
        f"host numpy in, text out)")
    return launches


# ---------------------------------------------------------------------------
def main():
    smi_line = phase_device()
    device = torch.device("cuda", 0)
    build_s = phase_build()
    kernels = phase_kernels(device)
    launches = phase_slice(device)
    say(f"[done] build {build_s:.2f} s; {smi_line}")
    say(json.dumps({"kernels": [{
        "name": "ctc_alpha",
        "route": "cuda",
        "source": "htr_vt_torch/csrc/ctc_alpha.cu",
        "replaces": "htr_vt_tpu/ops/ctc_pallas.py:55",
        "launches": launches,
        "max_abs_err": max(k["max_abs_err"] for k in kernels.values()),
        "ms": kernels["S193"]["ms"],
        "plain_ms": kernels["S193"]["plain_ms"],
        "shape": "B128 T128 C80 S193",
        "ms_s17": kernels["S17"]["ms"],
        "plain_ms_s17": kernels["S17"]["plain_ms"],
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
