#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``htr_vt_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in this order, each printing its own lines; any failure exits
non-zero before the last line:

0. device: a CUDA device is required (there is no CPU path); prints the
   card's name and power limit as nvidia-smi gives them; TF32 off.
1. build: compiles ``htr_vt_torch/csrc/*.cu`` with nvcc for sm_90a into the
   git-ignored ``build/htr_vt_torch/``.
2. CTC kernels vs plain: the alpha kernel against ``ctc_alpha_reference``,
   the beta kernel against ``ctc_beta_reference`` (two calls bit-equal),
   the loss against the plain ``ctc_loss`` and against ``F.ctc_loss``, and
   ``d logits`` through both kernels against autograd through the plain
   loop, at the labelled train/eval shape (B=128, T=128, C=80, Lmax=96 ->
   S=193, with length-0 and infeasible rows), the serving dummies (Lmax=8,
   all lengths 0 -> S=17) and the wide steps' shapes (B=64, T=256 and 512,
   Lmax 56 and 112 -> S=113 and 225), with times, ``F.ctc_loss`` as the
   library yardstick, the bound and the cycles a frame. Then past the
   register path (S > 8192): a padded batch of 16 rows, four of them labels
   of 4500 or 10000 characters (S = 9001, 20001) that cannot be aligned in
   128 frames; both kernels take their strided path and give the plain
   loops' bits, and ``ctc_loss_auto`` zeroes the long rows' loss and
   gradient, with times and bounds.
3. stem kernels vs plain: K2 (``bn_stats``, one kernel a call) at the four
   stem activations of the flagship at bs 128, with its ``torch.profiler``
   split by kernel (``kernel_split``: kernels a call, device time of each,
   gaps; at bs 128 and at batch 1) and at C = 12 and 20 (bf16 and float32, the
   scalar loads), K3f and K3b (``pool_bn_relu_fwd``/``_bwd``) at
   the conv1 output [128, 192, 32, 512], bf16 channels-last, against their
   plain versions (two calls bit-equal; K3b also with g as contiguous NCHW,
   the layout the step hands it, bit-equal to the channels-last g), with
   CUDA-event times of kernel (K3b with either g), plain version and the
   library or stock yardstick, and the bound. Then K3f and K3b at C = 12,
   20 and 25 (the entry site of an embed-4C model, [128, C, 32, 512], g
   NCHW), which the wrappers run on copies zero-padded to a multiple of 8:
   y and dx bit-equal to the plain versions, timed with the copies and
   beside the same site at the padded width.
4. conv kernels vs plain: K4f, K4d and K4w (``conv3x3_bn_relu_fwd`` /
   ``_dgrad`` / ``_wgrad``) at the flagship's three stride-1 conv sites at
   bs 128 (stage 1 [128, 192, 8, 512], stage 2 [128, 384, 4, 256], stage 3
   [128, 768, 2, 128], C -> C, bf16 channels-last), with and without the
   BN prologue, against their plain versions; two calls bit-equal;
   CUDA-event times of kernel (with and without the prologue), plain
   version, cuDNN doing the conv alone on the pre-normalised tensor (the
   yardstick of the kernel without the prologue), for K4f and K4w the stock
   two-call route (the eager prologue, then ``F.conv2d`` or
   ``torch.nn.grad.conv2d_weight``: the yardstick of the kernel with it),
   and the bound. Then the three with the prologue at C = 12, 20 and 25
   (the stage-1 site of an embed-4C model, [128, C, 8, 512], C -> C, on
   zero-padded copies), held and timed the same way, beside the padded
   width.
5. serve: the flagship ``ModelConfig()`` (64x512, embed 768, depth 4, heads
   6, 80 classes, bf16) with seeded random weights serves 3x128+37 line
   images through ``cli.serve.transcribe``, then runs one ``eval_step`` with
   real labels; the alpha kernel must launch once per ``eval_step`` and
   nothing else. The same weights in float32 bound the bf16 error. Prints
   ms/batch, img/s and the peak device memory.
6. fused-stem serve: the same weights with ``pool_impl="pallas"`` serve the
   same images and run the labelled ``eval_step``; one K3f launch per
   ``eval_step``, no K2 or K3b, and the logits and texts equal the stock
   stem's bit for bit.
7. fully fused serve: the same with ``conv_impl="pallas"`` as well; 9 K4f
   and 1 K3f per ``eval_step``, frame-argmax agreement with the stock bf16
   logits >= 99% (the kernels sum in another order than cuDNN, so the
   logits are not bit-equal), the largest logit difference printed.
8. train: the flagship with the IAM recipe's span masking (ratio 0.4, max
   span 8) takes 2 warm-up and 10 timed SAM ``train_step``s at bs 128
   (labels of length 1-96, 8 of them infeasible); each step must launch the
   alpha and the beta kernel exactly twice. Then ``validate`` runs the EMA
   model over 2 batches (one alpha launch each, no beta), and a learning
   check trains 20 steps on one fixed batch of 16, whose pass-1 loss must
   fall. Prints ms/step, img/s, the peak device memory and CER/WER.
9. fused-stem train: phase 8 with ``bn_stats_impl="pallas",
   pool_impl="pallas"``: the same weights, batch and masks give the stock
   stem's first pass-1 loss to bf16 noise; each timed step launches K2 32
   times, K3f, K3b, alpha and beta twice each, and K3b's incoming gradient
   is never copied (``PoolBNReLU.grad_copies`` == 0); EMA ``validate``
   launches K3f and alpha once per batch; the learning check's loss must
   fall.
10. fully fused train: phase 9 with ``conv_impl="pallas"`` as well; each
   step also launches K4f, K4d and K4w 18 times each, and EMA ``validate``
   9 K4f per batch.
11. flash-attention kernels vs plain: K5f (``flash_attention_fwd``) at the
   serving shapes [128, 6, 256, 128] and [128, 6, 512, 128] (the 1024- and
   2048-px buckets), and K5f, K5dkv and K5dq at the training shapes [64, 6,
   256, 128] and [64, 6, 512, 128], in bf16 and float32 (TF32 off); at
   head_dim 256 (embed 1536 over 6 heads) K5f at [128, 6, 512, 256] and the
   three at [64, 6, 512, 256] in bf16, and the three in float32 at [2, 3,
   256, 256]; at head_dim 384 and 512 (embed 2304, 3072 over 6 heads: the
   FFMA kernels) the three at [64, 6, 512, D] in bf16 (>= 99% of the
   elements bit-equal) and at [2, 3, 256, D] in float32; on the strided q,
   k, v views of a fused qkv projection,
   against their plain versions; two calls bit-equal; CUDA-event times of
   kernel, plain version and ``F.scaled_dot_product_attention`` (forward,
   forward + backward, and the backward alone, its forward run outside the
   timed window) on the same q, k and v, never on the path; the bounds.
12. bucket serve: the serve phase's weights (stock stem) serve 421
   synthetic lines of natural widths ``n_chars * 24 + 32`` px (the JAX
   selftest ramp, 4-96 characters: 128-2336 px) through
   ``cli.serve.transcribe_buckets``, routed to 512, 1024 and 2048 px at bs
   128; ``depth`` = 4 K5f per ``eval_step`` at 1024 and 2048 and none at
   512; per bucket the lines, batches, ``eval_step`` ms, img/s and peak
   memory, and at 1024 and 2048 the logits against the same weights with
   ``attn_impl="xla"`` (frame argmax agreement >= 99%).
13. wide train: the multi-width recipe's step (one ``TrainState``, bs 64,
   IAM span masking, ``OptimConfig()``), 12 SAM ``train_step``s alternating
   1024 and 2048 px with labels of up to 56 and 112 characters; exactly 8
   K5f, 8 K5dkv, 8 K5dq, 2 alpha and 2 beta launches per step; EMA
   ``validate`` at 2048 px; ms/step, img/s and peak memory per width; a
   20-step learning check at bs 16 and 2048 px.
14. fit: ``htr_vt_torch.train.loop.fit`` trains the flagship fully fused
   (bs 128, IAM span masking, ``OptimConfig()``) on 1024 train and 256 val
   seeded in-memory uint8 lines with texts of 1-96 characters
   (``LineSet``; augmentation off: the card's machine has no cv2) for 6
   steps, evaluating the EMA model and checkpointing every 3; its kernel
   launches must be exactly 6 SAM steps' and 2 x 2 eval batches'. Then a
   3-step run with an auto-resume to 6 in another run directory, held to
   it in default mode at stated bars (``FIT_LOSS_REL``, ``FIT_STATE_L2``,
   ``FIT_LEAF_SHARE``); under ``torch.use_deterministic_algorithms`` the
   same pair held bit for bit (losses, model, EMA, AdamW, step,
   generator), and the default-mode run held against it at the bars; in
   default mode with only the CTC class sum in a fixed order
   (``fixed_order_class_sum``) the pair again bit for bit, which names
   ``scatter_add_``'s atomics in the CTC glue as the op that keeps
   default-mode runs apart; best_CER served through
   ``cli/serve.py:load_serving_model``, its frame argmax equal to
   ``eval_step`` on the restored EMA model; img/s
   from the loop's ``StepTimer``, checkpoint save and restore ms, peak
   memory. The checkpoints live in a temporary directory under the
   git-ignored ``build/``, removed at the end.

Kernel times (phases 2, 3, 4 and 11) are read two ways: ``median_ms``, one
wrapper call between two CUDA events (host work in the wrapper included;
the times of earlier runs), and ``device_ms``, the device time a launch: a
run of back-to-back calls queued behind a spin kernel, so that the window
holds the device's work alone, divided by its length (inputs that the step
finds cold in L2 are cycled through copies that together exceed it). The
JSON record's ``ms`` and ``library_ms`` are device times a launch,
``call_ms`` and ``library_call_ms`` the single calls.

The second-to-last line is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from htr_vt_torch import (CTCLabelConverter, ExperimentConfig,  # noqa: E402
                          MaskConfig, ModelConfig, OptimConfig, _build)
from htr_vt_torch.cli.serve import (load_serving_model, transcribe,  # noqa: E402
                                    transcribe_buckets)
from htr_vt_torch.config import AugmentConfig, DataConfig, TrainConfig  # noqa: E402
from htr_vt_torch.eval.validate import validate  # noqa: E402
from htr_vt_torch.models.htr_vt import build_model  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from htr_vt_torch.ops import (conv_fused, ctc_cuda, flash_attn,  # noqa: E402
                              pool_fused)
from htr_vt_torch.ops.bn_stats import bn_stats, bn_stats_reference  # noqa: E402
from htr_vt_torch.ops.ctc import NEG, ctc_loss, ctc_loss_auto  # noqa: E402
from htr_vt_torch.train import loop  # noqa: E402
from htr_vt_torch.train.checkpoint import CheckpointManager  # noqa: E402
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
# where autograd's own error is 4.9e-5); the bar scales with the loss. Each
# frame rounds alpha and beta once more, so past the 128 frames it was set
# at it also scales with the frames (the wide steps' 256 and 512).
POSTERIOR_ULPS, POSTERIOR_FRAMES = 16, 128
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
VAL_ROWS = (BATCH, BATCH - 7)  # valid rows of the 2 validation batches
LEARN_BATCH, LEARN_STEPS = 16, 20
# bf16 vs float32 serving on the same weights: frame-argmax agreement floor.
MIN_ARGMAX_AGREEMENT = 0.99
SENTINEL = NEG / 10  # alpha entries below this are the unreachable mark
# The port's loss against F.ctc_loss: two independent float32 log-space
# recursions over 128 frames, at losses of up to ~900.
LIBRARY_LOSS_RTOL = 1e-4
# The bound: the larger of bytes over the memory rate and operations over
# the card's peak for their type: float32 outside the tensor cores, bf16
# dense on them (H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# Per state and frame, the recursion's logaddexp3 and emission add: three
# exp, one log, two max, four adds.
CTC_OPS_PER_STATE = 10
# device_ms: back-to-back calls a run, runs (the median is kept), and the
# card's L2, which inputs that the step reads cold must exceed together.
DEVICE_RUN, DEVICE_RUNS = 20, 5
L2_BYTES = 50 * 2**20
# The stem activations K2 reads in one forward of the flagship at bs 128
# (NCHW, stored channels-last): once at the entry, 5 times at each stage.
STEM_SITES = (("entry", (BATCH, 192, 32, 512), 1), ("stage1", (BATCH, 192, 8, 512), 5),
              ("stage2", (BATCH, 384, 4, 256), 5), ("stage3", (BATCH, 768, 2, 128), 5))
# K2 against its plain version: two float32 sums of B*H*W terms in other
# orders, each within ~1e-6 of sum |x| of the exact sum
# (tests/test_torch_port_cuda.py holds the kernel to float64).
STATS_SUM_REL, STATS_SQ_RTOL = 2e-6, 2e-5
# K3b's dscale/dshift against the plain version: float32 sums of B*H*W terms
# in other orders, within 1e-5 of the sum of the terms' magnitudes.
POOL_RED_REL = 1e-5
FUSED = dict(bn_stats_impl="pallas", pool_impl="pallas")
FULLY_FUSED = dict(FUSED, conv_impl="pallas")
# Fused vs stock stem, first pass-1 loss on the same weights, batch and
# masks: the dataflows round to bf16 at other places.
FUSED_LOSS_RTOL = 1e-2
# The flagship's stride-1 conv sites at bs 128, C -> C: the block
# activations of stages 1, 2 and 3 (3 K4f calls each per forward).
CONV_SITES = (("stage1", (BATCH, 192, 8, 512)), ("stage2", (BATCH, 384, 4, 256)),
              ("stage3", (BATCH, 768, 2, 128)))
# K4 against its plain version (the bars of tests/test_torch_port_cuda.py):
# float32 sums in another order, within CONV_SUM_REL of the sum of the
# terms' magnitudes, then one bf16 rounding on each side (2^-7 of the value).
CONV_SUM_REL, BF16_ULP_REL = 1e-5, 2.0**-7
COUNTERS = {"ctc_alpha": ctc_cuda.ctc_alpha, "ctc_beta": ctc_cuda.ctc_beta,
            "bn_stats": bn_stats,
            "pool_bn_relu_fwd": pool_fused.pool_bn_relu_fwd,
            "pool_bn_relu_bwd": pool_fused.pool_bn_relu_bwd,
            "conv3x3_bn_relu_fwd": conv_fused.conv3x3_bn_relu_fwd,
            "conv3x3_bn_relu_dgrad": conv_fused.conv3x3_bn_relu_dgrad,
            "conv3x3_bn_relu_wgrad": conv_fused.conv3x3_bn_relu_wgrad,
            "flash_attention_fwd": flash_attn.flash_attention_fwd,
            "flash_attention_bwd_dkv": flash_attn.flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": flash_attn.flash_attention_bwd_dq}
# K5 at the width buckets' shapes, [B, H, N, D] (name, shape, backward too,
# dtypes): bs 128 serving and the multi-width recipe's bs 64 training, N =
# 256 at 1024 px and 512 at 2048 px, head_dim 768 / 6; and head_dim 256
# (embed 1536 / 6) at the 2048-px shapes, float32 at one small shape.
BOTH = (torch.bfloat16, torch.float32)
FLASH_SHAPES = (("serve1024", (BATCH, 6, 256, 128), False, BOTH),
                ("serve2048", (BATCH, 6, 512, 128), False, BOTH),
                ("train1024", (64, 6, 256, 128), True, BOTH),
                ("train2048", (64, 6, 512, 128), True, BOTH),
                ("serve2048_d256", (BATCH, 6, 512, 256), False, (torch.bfloat16,)),
                ("train2048_d256", (64, 6, 512, 256), True, (torch.bfloat16,)),
                ("small_d256", (2, 3, 256, 256), True, (torch.float32,)),
                # head_dim 384 and 512 (embed 2304, 3072 over 6 heads): the
                # FFMA kernels, bf16 at the 2048-px training shape, float32
                # at a small one
                ("train2048_d384", (64, 6, 512, 384), True, (torch.bfloat16,)),
                ("train2048_d512", (64, 6, 512, 512), True, (torch.bfloat16,)),
                ("small_d384", (2, 3, 256, 384), True, (torch.float32,)),
                ("small_d512", (2, 3, 256, 512), True, (torch.float32,)))
# K5 against its plain version (the bars of tests/test_torch_port_cuda.py):
# float32, 1e-4 of the value and 1e-5 of the tensor's largest (float32 sums
# in other orders); bf16, one bf16 ulp of the value (2^-7) and 2^-8 of the
# largest (p and ds are rounded to bf16 before each product, and a few
# float32 ulps can move a value across a rounding boundary).
FLASH_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0**-7, 2.0**-8)}
# ... and at head_dim past 256 (the FFMA kernels), bf16 outputs at least this
# share bit-equal to the plain version's (the CPU tests' bar against JAX).
FLASH_MIN_EQUAL = 0.99
SERVE_WIDTHS = (512, 1024, 2048)  # cli/serve.py --width-buckets
N_LINES = 421
# The JAX serve selftest's line widths (htr_vt_tpu/data/synthetic.py:64-75)
SELFTEST_PX_PER_CHAR, SELFTEST_PAD_PX = 24, 32
WIDE_BATCH = 64  # tools/train_multiwidth.py --bs
WIDE_LMAX = {1024: 56, 2048: 112}  # max(6, 28 * w / 512) characters
WIDE_STEPS = 12
# The CTC kernels' cases (name, B, T, Lmax, all lengths 0): the labelled
# train/eval shape, the serving dummies and the wide steps' (T = W / 4).
CTC_CASES = (("S193", BATCH, 128, LMAX, False), ("S17", BATCH, 128, SERVE_LMAX, True),
             ("W1024", WIDE_BATCH, 256, WIDE_LMAX[1024], False),
             ("W2048", WIDE_BATCH, 512, WIDE_LMAX[2048], False))
# Past the register path (S > 8192): the kernels' strided path, at labels of
# 4500 and 10000 characters in a padded batch of 16 (name, Lmax); the long
# rows cannot be aligned in T = 128 frames.
CTC_LONG_CASES = (("S9001", 4500), ("S20001", 10000))
CTC_LONG_BATCH = 16
# K2 at channel counts that are not multiples of 8 (the scalar loads):
# [B, C, H, W] bf16 and float32, held to the sites' bars.
STATS_ANY_C = (("C12", (BATCH, 12, 32, 128)), ("C20", (BATCH, 20, 16, 64)))
# K3 and K4 at stem widths that are not multiples of 8 (the wrappers' padded
# copies): the entry (K3) and stage-1 (K4, C -> C) sites of a 64x512 model
# of embed_dim 4C at bs 128, bf16; beside each, the same site at the padded
# width, where no copy is made.
TAIL_CHANNELS = (12, 20, 25)
# The fit phase: seeded in-memory lines (train, val), the uninterrupted run's
# steps, eval cadence and print cadence, and the split run's first leg.
FIT_LINES = (1024, 256)
FIT_STEPS, FIT_EVAL, FIT_PRINT, FIT_SPLIT = 6, 3, 3, 3
# Two default-mode runs on the card need not give equal bits: the CTC
# gradient's glue sums each class's states with scatter_add_'s float atomics
# (ops/ctc_cuda.py:class_sum), in no fixed order, and cuDNN may take
# nondeterministic backward algorithms for the convs the stem kernels leave
# to it. Under torch.use_deterministic_algorithms both take deterministic
# routes (and cuBLAS asks for this workspace setting), and the resume is held
# bit for bit.
CUBLAS_DETERMINISTIC = ":4096:8"
# A default-mode run (the way fit runs) held against another run of the same
# steps, at about 4x the largest reading on the H100 (PERF.md section 6;
# ten comparisons, four with the L2 norms): each pass-1 loss's relative gap
# (read up to 5.95e-4);
# for the model, the EMA model and the AdamW moments the L2 norm of the gap
# over the L2 norm of the state (read up to 6.0e-4, 5.2e-4 and 0.24: six
# warm-up steps carry a few ulps of the CTC sum into the moments that far);
# and each leaf's largest |gap| over its largest |value| (read up to 1.9: a
# leaf whose exact gradient is zero, such as the attention's key bias, gets
# rounding noise that AdamW scales to full-size steps). These catch a gross
# fault only; the resume is held bit for bit under deterministic algorithms
# and with the CTC class sum in a fixed order.
FIT_LOSS_REL, FIT_LEAF_SHARE = 2e-3, 4.0
FIT_STATE_L2 = {"model": 2.5e-3, "ema_model": 2.5e-3, "adamw": 1.0}


def per_step_launches(switches):
    """Launches of each kernel per SAM train step with the stem switches."""
    want = {"ctc_alpha": 2, "ctc_beta": 2}
    if switches.get("bn_stats_impl") == "pallas":
        want["bn_stats"] = 32  # every BN of the stem, both passes
    if switches.get("pool_impl") == "pallas":
        want.update(pool_bn_relu_fwd=2, pool_bn_relu_bwd=2)
    if switches.get("conv_impl") == "pallas":  # 9 stride-1 convs a forward
        want.update(conv3x3_bn_relu_fwd=18, conv3x3_bn_relu_dgrad=18,
                    conv3x3_bn_relu_wgrad=18)
    return want


def per_eval_launches(switches):
    """Launches of each kernel per ``eval_step`` with the stem switches."""
    want = {"ctc_alpha": 1}
    if switches.get("pool_impl") == "pallas":
        want["pool_bn_relu_fwd"] = 1
    if switches.get("conv_impl") == "pallas":
        want["conv3x3_bn_relu_fwd"] = 9
    return want


def posterior_atol(loss, frames=POSTERIOR_FRAMES):
    ulps = POSTERIOR_ULPS * max(frames, POSTERIOR_FRAMES) / POSTERIOR_FRAMES
    return max(GRAD_ATOL, ulps * 2.0**-24 * loss.abs().max().item())


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


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _hold_stream(ms):
    """Keep the current stream busy on the device for at least ``ms``: a
    spin of ``ms`` x 2e6 cycles (an H100's SM clock is at most 1980 MHz)."""
    torch.cuda._sleep(int(ms * 2e6))


def _queue_hold(calls, n):
    """Warm ``calls`` up and return the spin (ms) that keeps the device busy
    while the host queues ``n`` of them: twice their host time, plus 1 ms."""
    for fn in calls * 2:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        calls[i % len(calls)]()
    hold = 2 * (time.perf_counter() - t0) * 1e3 + 1.0
    torch.cuda.synchronize()
    return hold


def device_ms(what, calls, n=DEVICE_RUN, runs=DEVICE_RUNS):
    """Device time a launch in milliseconds: the median over ``runs`` of the
    CUDA-event time of ``n`` back-to-back calls, divided by ``n``. A spin
    kernel holds the stream while the host queues the calls, so the window
    holds the device's work and not the wrapper's host time. ``calls`` are
    zero-argument callables taken in turn (copies of the inputs, so that
    the step's cold inputs arrive cold). Says so where the host could not
    queue a run ahead of the device (a call that waits on the device)."""
    calls = list(calls)
    hold = _queue_hold(calls, n)
    times, late = [], 0
    for _ in range(runs):
        start, end = _events()
        _hold_stream(hold)
        start.record()
        t0 = time.perf_counter()
        for i in range(n):
            calls[i % len(calls)]()
        late += (time.perf_counter() - t0) * 1e3 > hold
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    if late:
        say(f"[device time] {what}: in {late} of {runs} runs the host queued the "
            "calls slower than the device ran them (a call waits on the device); "
            "host gaps are inside that time")
    return statistics.median(times)


def _profiled_run(calls, hold):
    """The device's kernels (start, end, name; the spin left out, in start
    order) of DEVICE_RUN calls queued behind a spin of ``hold`` ms, as
    ``torch.profiler`` records them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _hold_stream(hold)
        for i in range(DEVICE_RUN):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin" not in e.name)  # torch.cuda._sleep's kernel


def kernel_split(what, calls):
    """The device's kernels of DEVICE_RUN back-to-back calls (the runs of
    ``device_ms``) under ``torch.profiler``: the kernels a call, each
    kernel's launches and device ms a call by name, the gaps inside a call
    (between its kernels) and between calls, and the span a call; each the
    median over DEVICE_RUNS runs. torch.profiler can drop kernel records of
    a run (on the H100 it has returned 18 and 13 of 20 kernels), so a run
    whose kernels are not a whole number a call is counted as lost, said,
    and run again, at most 2 x DEVICE_RUNS times; ``lost_runs`` counts them.
    A kept run's kernels a call is its record count over DEVICE_RUN, and
    ``per_call`` lists every kept run's, so a gate can hold all of them."""
    calls = list(calls)
    hold = _queue_hold(calls, DEVICE_RUN)
    kept, lost = [], 0
    while len(kept) < DEVICE_RUNS:
        kernels = _profiled_run(calls, hold)
        if not kernels or len(kernels) % DEVICE_RUN:
            lost += 1
            say(f"[profiler] {what}: run with {len(kernels)} kernel records for "
                f"{DEVICE_RUN} calls, counted as lost ({lost})")
            if lost > 2 * DEVICE_RUNS:
                raise AssertionError(f"[profiler] {what}: {lost} runs lost kernel "
                                     "records")
            continue
        kept.append(kernels)
    med = statistics.median
    per_call = [len(k) // DEVICE_RUN for k in kept]
    by_name = {}
    for k in kept:
        for name in {e[2] for e in k}:
            ms = [(e[1] - e[0]) * 1e-3 for e in k if e[2] == name]
            by_name.setdefault(name, []).append((len(ms), sum(ms)))
    inside, between, span = [], [], []
    for k, pc in zip(kept, per_call):
        gaps = [((k[i][0] - k[i - 1][1]) * 1e-3, i % pc == 0) for i in range(1, len(k))]
        inside += [g for g, first in gaps if not first]
        between += [g for g, first in gaps if first]
        span.append((k[-1][1] - k[0][0]) * 1e-3 / DEVICE_RUN)
    return dict(
        per_call=per_call, launches_a_call=med(per_call), lost_runs=lost,
        span_ms=med(span), gap_inside_ms=med(inside) if inside else None,
        gap_between_ms=med(between) if between else None,
        kernels={name: dict(launches_a_call=med(n for n, _ in v) / DEVICE_RUN,
                            ms_a_call=med(t for _, t in v) / DEVICE_RUN)
                 for name, v in sorted(by_name.items())})


def short_name(kernel):
    """A kernel's function name without its return type, namespace and
    parameters: "void (anonymous namespace)::f<int>(int*)" -> "f<int>"."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name[len("void "):] if name.startswith("void ") else name
    return re.sub(r"^(\w+::)*", "", name.split("(")[0])


def describe(split):
    parts = [f"{short_name(k)} {v['ms_a_call']:.4f} ms x {v['launches_a_call']:g}"
             for k, v in split["kernels"].items()]
    gaps = f"gap between calls {split['gap_between_ms']:.4f} ms"
    if split["gap_inside_ms"] is not None:
        gaps = f"gap inside a call {split['gap_inside_ms']:.4f} ms, " + gaps
    return (f"{split['launches_a_call']:g} kernel(s) a call: {', '.join(parts)}; "
            f"{gaps}; span {split['span_ms']:.4f} ms a call; "
            f"{split['lost_runs']} run(s) lost")


def cold_copies(x):
    """x and enough copies of it that together they exceed twice the L2."""
    n = max(1, math.ceil(2 * L2_BYTES / (x.numel() * x.element_size())))
    return [x] + [x.clone() for _ in range(n - 1)]


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def bound(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    """(ms, what bounds it): the least time for moving ``n_bytes`` and doing
    ``n_ops`` operations at ``ops_per_s`` (float32 by default) on the card."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# ---------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[device] {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")
    smi_line = smi.strip().splitlines()[0]
    say(smi_line)
    max_sm_mhz = float(clock.strip().splitlines()[0])
    say(f"[device] max SM clock {max_sm_mhz:.0f} MHz")
    return smi_line, max_sm_mhz


def phase_build():
    t0 = time.perf_counter()
    log = _build.build()
    seconds = time.perf_counter() - t0
    _build.library()
    for line in log.splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                or "spill stores" in line):
            say(f"[build] {line.strip()}")
    say(f"[build] nvcc sm_90a -> {os.path.relpath(_build.LIBRARY)} in "
        f"{seconds:.2f} s")
    return seconds


# ---------------------------------------------------------------------------
def ctc_case(seed, b, t, lmax, zero_lengths, device):
    """[b, t, 80] logits and labels of up to ``lmax``. Labelled case: 8 rows
    of length 0, and 8 rows of ``lmax`` identical labels, which need 2 *
    lmax - 1 frames (more than T=128 at Lmax=96: they cannot be aligned)."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((b, t, 80))).astype(np.float32)
    labels = rng.integers(1, 80, (b, lmax)).astype(np.int32)
    if zero_lengths:
        lengths = np.zeros(b, np.int32)
    else:
        lengths = rng.integers(1, lmax + 1, b).astype(np.int32)
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


def phase_kernels(device, max_sm_mhz):
    results = {}
    for name, b, t, lmax, zero in CTC_CASES:
        logits, labels, lengths = ctc_case(SEED + lmax, b, t, lmax, zero, device)
        logp = torch.log_softmax(logits, dim=-1).contiguous()
        z, noskip, valid, start2, endm = ctc_cuda.extended_masks(labels, lengths)
        runs = [(ctc_cuda.ctc_alpha(logp, z, noskip, valid, start2),
                 ctc_cuda.ctc_beta(logp, z, noskip, valid, endm)) for _ in range(2)]
        torch.cuda.synchronize()
        (alpha_k, beta_k), again = runs
        if not all(torch.equal(x, y) for x, y in zip(runs[0], again)):
            raise AssertionError(f"[{name}] two calls of a CTC kernel gave different bits")
        del runs, again
        alpha_err, n_alpha = _hold(name, "alpha", alpha_k, ctc_cuda.ctc_alpha_reference(
            logp, z, noskip, valid, start2))
        beta_err, n_beta = _hold(name, "beta", beta_k, ctc_cuda.ctc_beta_reference(
            logp, z, noskip, valid, endm))
        del alpha_k, beta_k
        loss_k, grad_k = _loss_grad(ctc_cuda.ctc_loss_cuda, logits, labels, lengths)
        loss_p, grad_p = _loss_grad(ctc_loss, logits, labels, lengths)
        torch.testing.assert_close(loss_k, loss_p, rtol=LOSS_RTOL, atol=0.0)
        loss_rel = ((loss_k - loss_p).abs() / loss_p.abs().clamp_min(1e-30)).max().item()
        if not torch.isfinite(grad_k).all():
            raise AssertionError(f"[{name}] non-finite kernel-path gradient")
        grad_g = _glue_over_plain(logits, labels, lengths)
        torch.testing.assert_close(grad_k, grad_g, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        glue_err = (grad_k - grad_g).abs().max().item()
        atol = posterior_atol(loss_p, t)
        grad_err = (grad_k - grad_p).abs().max().item()
        say(f"[kernel {name}] d logits vs autograd through the plain loop: max|err| "
            f"{grad_err:.3e} (rtol {GRAD_RTOL}, atol {atol:.3e})")
        torch.testing.assert_close(grad_k, grad_p, rtol=GRAD_RTOL, atol=atol)
        infeasible = (loss_p == 0) & (lengths > 0)
        if (grad_k[infeasible] != 0).any() or (grad_p[infeasible] != 0).any():
            raise AssertionError(f"[{name}] an infeasible row has a gradient")
        n_zero = int((loss_p == 0).sum())

        def alpha():
            return ctc_cuda.ctc_alpha(logp, z, noskip, valid, start2)

        def beta():
            return ctc_cuda.ctc_beta(logp, z, noskip, valid, endm)

        times = dict(
            alpha_ms=device_ms(f"{name} alpha", [alpha]),
            alpha_call_ms=median_ms(alpha, 50),
            alpha_plain_ms=median_ms(lambda: ctc_cuda.ctc_alpha_reference(
                logp, z, noskip, valid, start2), 10),
            beta_ms=device_ms(f"{name} beta", [beta]),
            beta_call_ms=median_ms(beta, 50),
            beta_plain_ms=median_ms(lambda: ctc_cuda.ctc_beta_reference(
                logp, z, noskip, valid, endm), 10),
            grad_ms=median_ms(lambda: _loss_grad(
                ctc_cuda.ctc_loss_cuda, logits, labels, lengths), 20),
            grad_plain_ms=median_ms(lambda: _loss_grad(
                ctc_loss, logits, labels, lengths), 5, warmup=1))
        # the library yardstick: F.ctc_loss on [T, B, C] log-probs, forward
        # for the alpha recursion, forward and backward for the beta one; the
        # lengths on the host, as it reads them there (lengths on the card
        # make each call wait for the device)
        lp_tbc = logp.transpose(0, 1).contiguous()
        t_len = torch.full((b,), t, dtype=torch.long)
        targets, target_len = labels.long(), lengths.long().cpu()

        def library_loss(lp):
            return F.ctc_loss(lp, targets, t_len, target_len, blank=0,
                              reduction="none", zero_infinity=True)

        def library_grad():
            lp = lp_tbc.detach().requires_grad_(True)
            library_loss(lp).sum().backward()

        loss_l = library_loss(lp_tbc)
        lib_finite = loss_l != 0
        if not torch.equal(lib_finite, loss_k != 0):
            raise AssertionError(f"[{name}] F.ctc_loss and the port disagree on "
                                 "which rows are infeasible")
        torch.testing.assert_close(loss_k[lib_finite], loss_l[lib_finite],
                                   rtol=LIBRARY_LOSS_RTOL, atol=0.0)
        lib_rel = ((loss_k - loss_l).abs()[lib_finite]
                   / loss_l[lib_finite].abs()).max().item()
        times["alpha_library_ms"] = device_ms(f"{name} F.ctc_loss forward",
                                              [lambda: library_loss(lp_tbc)])
        times["alpha_library_call_ms"] = median_ms(lambda: library_loss(lp_tbc), 50)
        times["beta_library_ms"] = device_ms(f"{name} F.ctc_loss forward + backward",
                                             [library_grad])
        times["beta_library_call_ms"] = median_ms(library_grad, 50)
        s = z.shape[1]
        cube = b * t * s
        n_bytes = logp.numel() * 4 + z.numel() * 4 + 3 * noskip.numel() + cube * 4
        times["bound_ms"], times["bound_by"] = bound(n_bytes, CTC_OPS_PER_STATE * cube)
        # the serial chain: T - 1 dependent frames a sample, at the max SM clock
        for which in ("alpha", "beta"):
            times[f"{which}_cycles_a_frame"] = (times[f"{which}_ms"] * 1e-3
                                                * max_sm_mhz * 1e6 / max(t - 1, 1))
        say(f"[kernel {name}] vs F.ctc_loss (reduction none, zero_infinity): "
            f"{int(lib_finite.sum())} finite rows max rel err {lib_rel:.3e} (rtol "
            f"{LIBRARY_LOSS_RTOL}), the same {int((~lib_finite).sum())} zero rows; "
            f"F.ctc_loss forward {times['alpha_library_ms']:.4f} ms device a launch "
            f"(one call {times['alpha_library_call_ms']:.4f}), forward + backward "
            f"{times['beta_library_ms']:.4f} (one call "
            f"{times['beta_library_call_ms']:.4f}); bound {times['bound_ms']:.4f} ms "
            f"by {times['bound_by']} ({n_bytes} bytes)")
        say(f"[kernel {name}] B={b} T={t} C=80 S={s}: two calls bit-equal; alpha "
            f"max|err| {alpha_err:.3e} over {n_alpha} finite entries, beta max|err| "
            f"{beta_err:.3e} over {n_beta} (rtol {ALPHA_RTOL}, atol "
            f"{ALPHA_ATOL}); reachability and sentinels equal; loss max rel "
            f"err {loss_rel:.3e} (rtol {LOSS_RTOL}; {n_zero} zero losses); "
            f"d logits vs the glue over plain recursions max|err| "
            f"{glue_err:.3e} (rtol {GRAD_RTOL}, atol {GRAD_ATOL}), vs autograd "
            f"through the plain loop {grad_err:.3e} (rtol {GRAD_RTOL}, atol "
            f"{atol:.3e}); {int(infeasible.sum())} infeasible rows exactly 0")
        say(f"[kernel {name}] alpha {times['alpha_ms']:.4f} ms device a launch "
            f"({times['alpha_cycles_a_frame']:.0f} cycles a frame at "
            f"{max_sm_mhz:.0f} MHz; one call {times['alpha_call_ms']:.4f} ms) vs "
            f"plain {times['alpha_plain_ms']:.4f} ms; beta {times['beta_ms']:.4f} "
            f"ms device a launch ({times['beta_cycles_a_frame']:.0f} cycles a "
            f"frame; one call {times['beta_call_ms']:.4f} ms) vs plain "
            f"{times['beta_plain_ms']:.4f} ms; loss + d logits "
            f"{times['grad_ms']:.4f} ms vs plain {times['grad_plain_ms']:.4f} ms")
        results[name] = dict(alpha_err=alpha_err, beta_err=beta_err,
                             grad_glue_err=glue_err, grad_err=grad_err,
                             library_rel_err=lib_rel, shape=[b, t, 80, s], **times)
    return results


def phase_ctc_long(device):
    """K1a/K1b past the register path: a padded batch of CTC_LONG_BATCH rows
    whose first four labels are 4500 or 10000 characters (S = 9001, 20001)
    and cannot be aligned in 128 frames, the rest 1-99 characters. The
    kernels take their strided path and give the plain loops' bits (two
    calls equal); ``ctc_loss_auto`` on the batch launches each kernel once,
    zeroes the long rows' loss and gradient and holds the others to the
    plain loss; times and bounds."""
    out = {}
    for name, lmax in CTC_LONG_CASES:
        b, t = CTC_LONG_BATCH, 128
        rng = np.random.default_rng(SEED + lmax)
        logits = (2.0 * rng.standard_normal((b, t, 80))).astype(np.float32)
        lengths = rng.integers(1, 100, b).astype(np.int32)
        lengths[:4] = lmax
        labels = rng.integers(1, 80, (b, lmax)).astype(np.int32)
        labels[np.arange(lmax)[None] >= lengths[:, None]] = 0
        logits, labels, lengths = (torch.from_numpy(a).to(device)
                                   for a in (logits, labels, lengths))
        logp = torch.log_softmax(logits, dim=-1).contiguous()
        z, noskip, valid, start2, endm = ctc_cuda.extended_masks(labels, lengths)
        s = z.shape[1]
        if ctc_cuda.recursion_geometry(t, 80, s)[0] != ctc_cuda.STRIDED:
            raise AssertionError(f"[kernel {name}] S={s} did not pick the strided path")

        def alpha():
            return ctc_cuda.ctc_alpha(logp, z, noskip, valid, start2)

        def beta():
            return ctc_cuda.ctc_beta(logp, z, noskip, valid, endm)

        runs = [(alpha(), beta()) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(*runs)):
            raise AssertionError(f"[kernel {name}] two calls of a CTC kernel gave different bits")
        alpha_k, beta_k = runs[0]
        del runs
        for what, got, want in (
                ("alpha", alpha_k, ctc_cuda.ctc_alpha_reference(logp, z, noskip, valid, start2)),
                ("beta", beta_k, ctc_cuda.ctc_beta_reference(logp, z, noskip, valid, endm))):
            if not torch.equal(got, want):
                raise AssertionError(f"[kernel {name}] {what}: the strided path and the "
                                     "plain loop differ")
        n_finite = int((alpha_k > SENTINEL).sum()), int((beta_k > SENTINEL).sum())
        del alpha_k, beta_k
        before = read_counts()
        x = logits.clone().requires_grad_(True)
        loss = ctc_loss_auto(x, labels, lengths)
        loss.sum().backward()
        after = read_counts()
        if (after["ctc_alpha"] - before["ctc_alpha"], after["ctc_beta"] - before["ctc_beta"]) \
                != (1, 1):
            raise AssertionError(f"[kernel {name}] ctc_loss_auto did not launch each "
                                 "kernel once")
        loss_p, grad_p = _loss_grad(ctc_loss, logits, labels, lengths)
        if (loss[:4] != 0).any() or (x.grad[:4] != 0).any() or (loss_p[:4] != 0).any():
            raise AssertionError(f"[kernel {name}] a long infeasible row is not zeroed")
        if not torch.isfinite(x.grad).all():
            raise AssertionError(f"[kernel {name}] non-finite gradient")
        torch.testing.assert_close(loss.detach(), loss_p, rtol=LOSS_RTOL, atol=0.0)
        torch.testing.assert_close(x.grad, grad_p, rtol=GRAD_RTOL,
                                   atol=posterior_atol(loss_p, t))
        cube = b * t * s
        n_bytes = logp.numel() * 4 + z.numel() * 4 + 3 * noskip.numel() + cube * 4
        rec = dict(shape=[b, t, 80, s], finite_alpha=n_finite[0], finite_beta=n_finite[1],
                   alpha_ms=device_ms(f"{name} alpha", [alpha]),
                   alpha_plain_ms=median_ms(lambda: ctc_cuda.ctc_alpha_reference(
                       logp, z, noskip, valid, start2), 3, warmup=1),
                   beta_ms=device_ms(f"{name} beta", [beta]),
                   beta_plain_ms=median_ms(lambda: ctc_cuda.ctc_beta_reference(
                       logp, z, noskip, valid, endm), 3, warmup=1),
                   loss_zeroed_rows=4)
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, CTC_OPS_PER_STATE * cube)
        out[name] = rec
        say(f"[kernel {name}] B={b} T={t} C=80 S={s}: the strided path; alpha and beta "
            f"bit-equal to the plain loops ({n_finite[0]} / {n_finite[1]} finite "
            f"entries), two calls bit-equal; ctc_loss_auto: one alpha and one beta "
            f"launch, the 4 long rows' loss and gradient exactly 0, the others "
            f"within rtol {LOSS_RTOL} of the plain loss; alpha {rec['alpha_ms']:.4f} "
            f"ms device a launch (plain {rec['alpha_plain_ms']:.4f}), beta "
            f"{rec['beta_ms']:.4f} ms (plain {rec['beta_plain_ms']:.4f}); bound "
            f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}")
        del logp, z, noskip, valid, start2, endm, x, loss
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
def line_images(n, rng, width=512):
    """[n, 64, width, 1] float32 "handwriting": dark random strokes on white
    over a random-length stretch of a text band."""
    img = np.ones((n, 64, width), np.float32)
    ink_len = rng.integers(64, width + 1, n)
    cols = np.arange(width)[None, None, :] < ink_len[:, None, None]
    rows = (np.arange(64) >= 16) & (np.arange(64) < 48)
    ink = (rng.random((n, 64, width)) < 0.2) & cols & rows[None, :, None]
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
    reset_counts()
    t0 = time.perf_counter()
    texts = transcribe(model, images, converter, BATCH)
    out = eval_step(model, test_batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["ctc_alpha"]
    peak = torch.cuda.max_memory_allocated()
    say(f"[serve] served {len(texts)} images in {math.ceil(N_IMAGES / BATCH)} "
        f"requests + 1 labelled eval_step in {wall:.3f} s (first call, "
        f"cuDNN autotune included); launches {counts} for {n_steps} eval_step "
        "calls")
    if counts != {**dict.fromkeys(COUNTERS, 0), "ctc_alpha": n_steps}:
        raise AssertionError(f"{n_steps} eval_step calls launched {counts}; "
                             "each must launch ctc_alpha once and nothing else")
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
    return launches, dict(model=model, images=images, texts=texts,
                          test_batch=test_batch, converter=converter,
                          logits=out["logits"], x_batch=x_batch)


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


def phase_train(device, switches=None, stock_first_loss=None, tag="train"):
    """Phase 8 (the stock stem) or, with ``switches``, phases 9 and 10 (the
    stem kernels): the same seed, batches and masks either way."""
    switches = switches or {}
    per_step, per_val = per_step_launches(switches), per_eval_launches(switches)
    model_cfg = ModelConfig(masking=MaskConfig(mode="span", ratio=0.4,
                                               max_span_length=8), **switches)
    cfg = ExperimentConfig(model=model_cfg, optim=OptimConfig())
    state = create_train_state(cfg, device,
                               torch.Generator(device=device).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 2)
    batch = train_batch(BATCH, model_cfg, rng, device, infeasible=8)
    say(f"[{tag}] HTRVT flagship {model_cfg.compute_dtype}, span masking "
        f"ratio 0.4 span 8, SAM rho {cfg.optim.sam_rho} + AdamW, bs {BATCH}, "
        f"labels of length 1-{LMAX} (8 infeasible); stem switches "
        f"{switches or 'stock'}")

    # --- the main path, counted ------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    first_loss = train_step(state, batch)["loss"].item()
    if stock_first_loss is not None:
        rel = abs(first_loss - stock_first_loss) / abs(stock_first_loss)
        say(f"[{tag}] first pass-1 loss {first_loss:.4f} vs the stock stem's "
            f"{stock_first_loss:.4f} on the same weights, batch and mask: rel "
            f"diff {rel:.3e} (rtol {FUSED_LOSS_RTOL})")
        if not rel <= FUSED_LOSS_RTOL:
            raise AssertionError(f"fused-stem loss {first_loss} vs stock "
                                 f"{stock_first_loss}")
    for _ in range(TRAIN_WARMUP - 1):
        train_step(state, batch)
    torch.cuda.synchronize()
    pool_fused.PoolBNReLU.grad_copies = conv_fused.ConvBNReLU.grad_copies = 0
    reset_counts()
    times, metrics = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(train_step(state, batch))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = read_counts()
    grad_copies = pool_fused.PoolBNReLU.grad_copies
    conv_copies = conv_fused.ConvBNReLU.grad_copies
    peak = torch.cuda.max_memory_allocated()
    want = {**dict.fromkeys(COUNTERS, 0),
            **{k: n * TRAIN_STEPS for k, n in per_step.items()}}
    if launches != want:
        raise AssertionError(f"{TRAIN_STEPS} train steps launched {launches}; "
                             f"each step must launch {per_step} and nothing else")
    values = {k: [m[k].item() for m in metrics] for k in metrics[0]}
    for k, v in values.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"non-finite {k}: {v}")
    ms = statistics.median(times)
    say(f"[{tag}] {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: median "
        f"{ms:.3f} ms/step ({BATCH / ms * 1e3:.1f} img/s; min {min(times):.3f}, "
        f"max {max(times):.3f}), peak memory {peak / 2**20:.1f} MiB; "
        f"launches {launches} ({per_step} per step)")
    if switches.get("pool_impl") == "pallas":
        say(f"[{tag}] K3b's incoming gradient was copied to channels-last in "
            f"{grad_copies} of {launches['pool_bn_relu_bwd']} backward calls")
        if grad_copies:
            raise AssertionError(f"[{tag}] K3b's gradient was copied {grad_copies} "
                                 "times; K3b reads the step's NCHW gradient as it comes")
    if switches.get("conv_impl") == "pallas":
        say(f"[{tag}] K4d/K4w's incoming gradient was copied to channels-last in "
            f"{conv_copies} of {launches['conv3x3_bn_relu_dgrad']} backward calls")
    say(f"[{tag}] loss " + " ".join(f"{v:.3f}" for v in values["loss"])
        + "; loss_second " + " ".join(f"{v:.3f}" for v in values["loss_second"])
        + "; grad_norm " + " ".join(f"{v:.3f}" for v in values["grad_norm"]))

    # --- EMA validation: eval BN, so no K2 and no backward ------------------
    alphabet = [chr(c) for c in range(33, 33 + model_cfg.nb_cls - 1)]
    converter = CTCLabelConverter(alphabet)
    val = []
    for n_valid in VAL_ROWS:  # the last batch padded past its valid rows
        b = train_batch(BATCH, model_cfg, rng, device)
        labels, lengths = b["labels"].cpu().numpy(), b["label_lengths"].cpu().numpy()
        texts = ["".join(alphabet[c - 1] for c in row[:n])
                 for row, n in zip(labels[:n_valid], lengths[:n_valid])]
        val.append((b, n_valid, texts))
    reset_counts()
    val_loss, cer, wer, preds, _ = validate(state.ema_model, val, converter)
    val_launches = read_counts()
    want = {**dict.fromkeys(COUNTERS, 0),
            **{k: n * len(VAL_ROWS) for k, n in per_val.items()}}
    if val_launches != want:
        raise AssertionError(f"validate launched {val_launches} for "
                             f"{len(VAL_ROWS)} batches; expected {want}")
    if not math.isfinite(val_loss) or len(preds) != sum(VAL_ROWS):
        raise AssertionError(f"validate: loss {val_loss}, {len(preds)} predictions")
    say(f"[{tag}] EMA validate over {len(VAL_ROWS)} batches ({len(preds)} valid "
        f"rows): loss {val_loss:.4f}, CER {cer:.4f}, WER {wer:.4f}; launches "
        f"{val_launches}")
    launches = {k: n + val_launches[k] for k, n in launches.items()}

    # --- learning check ---------------------------------------------------
    learn = create_train_state(
        dataclasses.replace(cfg, optim=OptimConfig(max_lr=3e-4, warmup_iters=5)),
        device, torch.Generator(device=device).manual_seed(SEED + 3))
    small = train_batch(LEARN_BATCH, model_cfg, np.random.default_rng(SEED + 4),
                        device)
    losses = [train_step(learn, small)["loss"].item() for _ in range(LEARN_STEPS)]
    say(f"[{tag}] learning check, {LEARN_STEPS} steps on one batch of "
        f"{LEARN_BATCH} (max_lr 3e-4, warmup 5): pass-1 loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"no learning: {losses}")
    return launches, dict(ms=ms, peak=peak, first_loss=first_loss,
                          grad_copies=grad_copies, conv_grad_copies=conv_copies)


# ---------------------------------------------------------------------------
def stem_input(shape, device, seed):
    """A bf16 channels-last activation of NCHW ``shape``, N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    return x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def stats_split(name, x, xs):
    """``kernel_split`` of ``bn_stats`` over ``xs`` (cold copies of the stem
    activation x), and over cold copies of x's first image: at batch 1 a
    call shows the part of its time that does not scale with the bytes."""
    ones = cold_copies(x[:1].clone(memory_format=torch.channels_last))
    return (kernel_split(f"K2 {name}", [lambda x=x: bn_stats(x) for x in xs]),
            kernel_split(f"K2 {name} batch 1", [lambda x=x: bn_stats(x) for x in ones]))


def phase_stem_kernels(device):
    """K2 at the four stem sites, K3f and K3b at the entry, against their
    plain versions; CUDA-event times and bounds."""
    out = {}
    sites = {}
    for name, shape, per_forward in STEM_SITES:
        x = stem_input(shape, device, seed=shape[1] + shape[2])
        c = shape[1]
        s_k, q_k = bn_stats(x)
        s_2, q_2 = bn_stats(x)
        s_p, q_p = bn_stats_reference(x)
        torch.cuda.synchronize()
        if not (torch.equal(s_k, s_2) and torch.equal(q_k, q_2)):
            raise AssertionError(f"[K2 {name}] two calls gave different bits")
        mag = x.float().abs().sum((0, 2, 3))
        err_s = (s_k - s_p).abs()
        if not (err_s <= STATS_SUM_REL * mag).all():
            raise AssertionError(f"[K2 {name}] sum off by "
                                 f"{(err_s / mag).max().item():.3e} of sum |x|")
        torch.testing.assert_close(q_k, q_p, rtol=STATS_SQ_RTOL, atol=0.0)
        n_bytes = x.numel() * 2 + 2 * c * 4
        # the step reads each site's activation cold: copies exceed the L2
        xs = cold_copies(x)
        site = dict(
            shape=list(shape), per_forward=per_forward, cold_copies=len(xs),
            max_abs_err=max(err_s.max().item(), (q_k - q_p).abs().max().item()),
            sum_err_of_abs_sum=(err_s / mag).max().item(),
            sumsq_rel_err=((q_k - q_p).abs() / q_p).max().item(),
            ms=device_ms(f"K2 {name}", [lambda x=x: bn_stats(x) for x in xs]),
            call_ms=median_ms(lambda: bn_stats(x), 20),
            plain_ms=median_ms(lambda: bn_stats_reference(x), 10),
            library_ms=device_ms(f"K2 {name} torch.batch_norm_stats", [
                lambda x=x: torch.batch_norm_stats(x, 1e-5) for x in xs]),
            library_call_ms=median_ms(lambda: torch.batch_norm_stats(x, 1e-5), 20))
        site["bound_ms"], site["bound_by"] = bound(n_bytes, 3 * x.numel())
        site["bound_share"] = site["bound_ms"] / site["ms"]
        # the device's kernels of a call by name, and the gaps between them
        # (torch.profiler over the same kind of run as device_ms)
        site["split"], site["split_batch1"] = stats_split(name, x, xs)
        site["launches_a_call"] = site["split"]["launches_a_call"]
        if site["split"]["per_call"] != [1] * DEVICE_RUNS:
            raise AssertionError(f"[K2 {name}] {site['split']['per_call']} kernels a "
                                 "call in the profiled runs, not one in each")
        sites[name] = site
        say(f"[K2 {name}] bn_stats bf16 {list(shape)}: two calls bit-equal; sum "
            f"max|err| {err_s.max().item():.3e} = {site['sum_err_of_abs_sum']:.3e} "
            f"of sum |x| (bar {STATS_SUM_REL}), sumsq max rel err "
            f"{site['sumsq_rel_err']:.3e} (rtol {STATS_SQ_RTOL}); kernel "
            f"{site['ms']:.4f} ms device a launch over {len(xs)} "
            f"input(s) ({site['bound_share']:.1%} of its bound; one call "
            f"{site['call_ms']:.4f} ms), plain {site['plain_ms']:.4f} ms, "
            f"torch.batch_norm_stats {site['library_ms']:.4f} ms device a launch "
            f"(one call {site['library_call_ms']:.4f}), bound "
            f"{site['bound_ms']:.4f} ms by {site['bound_by']}; profiler: "
            f"{describe(site['split'])}; at batch 1: {describe(site['split_batch1'])}")
        del x, xs
    out["bn_stats"] = sites
    # any C: channel counts that are not multiples of 8
    any_c = {}
    for name, shape in STATS_ANY_C:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=device).manual_seed(shape[1])
            x = torch.randn(shape, generator=gen, device=device).to(dtype).contiguous(
                memory_format=torch.channels_last)
            runs = [bn_stats(x) for _ in range(2)]
            s_p, q_p = bn_stats_reference(x)
            torch.cuda.synchronize()
            (s_k, q_k), (s_2, q_2) = runs
            if not (torch.equal(s_k, s_2) and torch.equal(q_k, q_2)):
                raise AssertionError(f"[K2 {name}] two calls gave different bits")
            mag = x.float().abs().sum((0, 2, 3))
            err_s = (s_k - s_p).abs()
            if not (err_s <= STATS_SUM_REL * mag).all():
                raise AssertionError(f"[K2 {name}] sum off by "
                                     f"{(err_s / mag).max().item():.3e} of sum |x|")
            torch.testing.assert_close(q_k, q_p, rtol=STATS_SQ_RTOL, atol=0.0)
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            any_c[f"{name}_{tag}"] = dict(
                shape=list(shape), sum_err_of_abs_sum=(err_s / mag).max().item(),
                sumsq_rel_err=((q_k - q_p).abs() / q_p).max().item(),
                ms=device_ms(f"K2 {name} {tag}", [lambda x=x: bn_stats(x)]))
            say(f"[K2 {name}] bn_stats {tag} {list(shape)} (C % 8 != 0: scalar "
                f"loads): two calls bit-equal; sum within "
                f"{any_c[f'{name}_{tag}']['sum_err_of_abs_sum']:.3e} of sum |x| (bar "
                f"{STATS_SUM_REL}), sumsq max rel err "
                f"{any_c[f'{name}_{tag}']['sumsq_rel_err']:.3e} (rtol {STATS_SQ_RTOL}); "
                f"{any_c[f'{name}_{tag}']['ms']:.4f} ms device a launch")
            del x, runs
    out["bn_stats_any_c"] = any_c

    name, shape, _ = STEM_SITES[0]
    x = stem_input(shape, device, seed=1)
    b, c, h, w = shape
    gen = torch.Generator(device=device).manual_seed(2)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=device)
    shift = 0.1 * torch.randn(c, generator=gen, device=device)
    g = torch.randn((b, c, h // 2, w), generator=gen, device=device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    y_k = pool_fused.pool_bn_relu_fwd(x, scale, shift)
    y_2 = pool_fused.pool_bn_relu_fwd(x, scale, shift)
    y_p = pool_fused.max_pool_bn_relu_reference(x, scale, shift)
    torch.cuda.synchronize()
    if not (torch.equal(y_k, y_p) and torch.equal(y_k, y_2)):
        raise AssertionError("[K3f] kernel and plain version differ, or two calls do")
    del y_2
    n_in, n_out = x.numel(), y_k.numel()
    fwd = dict(shape=list(shape), max_abs_err=0.0,
               ms=device_ms("K3f", [lambda: pool_fused.pool_bn_relu_fwd(x, scale, shift)]),
               call_ms=median_ms(lambda: pool_fused.pool_bn_relu_fwd(x, scale, shift), 20),
               plain_ms=median_ms(lambda: pool_fused.max_pool_bn_relu_reference(
                   x, scale, shift), 10))
    # per input element: multiply, add, ReLU; per output: 8 compares
    fwd["bound_ms"], fwd["bound_by"] = bound(2 * n_in + 2 * n_out + 2 * c * 4,
                                             3 * n_in + 8 * n_out)
    say(f"[K3f] pool_bn_relu_fwd bf16 {list(shape)} -> {list(y_k.shape)}: bit-equal "
        f"to the plain version; kernel {fwd['ms']:.4f} ms device a launch (one call "
        f"{fwd['call_ms']:.4f} ms), plain (the stock ops) "
        f"{fwd['plain_ms']:.4f} ms, bound {fwd['bound_ms']:.4f} ms by "
        f"{fwd['bound_by']}")
    del y_k, y_p

    # K3b reads g channels-last or, as the step hands it, contiguous NCHW
    g_nchw = g.contiguous()
    dx_k, ds_k, dt_k = pool_fused.pool_bn_relu_bwd(g, x, scale, shift)
    again = pool_fused.pool_bn_relu_bwd(g, x, scale, shift)
    nchw = pool_fused.pool_bn_relu_bwd(g_nchw, x, scale, shift)
    dx_p, ds_p, dt_p = pool_fused.pool_bn_relu_bwd_reference(g, x, scale, shift)
    torch.cuda.synchronize()
    if not torch.equal(dx_k, dx_p):
        raise AssertionError("[K3b] dx: kernel and plain version differ")
    for what, run in (("two calls", again), ("an NCHW g and a channels-last g", nchw)):
        if not all(torch.equal(a, b) for a, b in zip((dx_k, ds_k, dt_k), run)):
            raise AssertionError(f"[K3b] {what} gave different bits")
    del again, nchw
    daf = pool_fused.routed_grad_reference(g, x, scale, shift)
    errs = []
    for what, got, want, term in (("dscale", ds_k, ds_p, daf * x.float()),
                                  ("dshift", dt_k, dt_p, daf)):
        mag = term.abs().sum((0, 2, 3))
        err = (got - want).abs()
        if not (err <= POOL_RED_REL * mag + 1e-6).all():
            raise AssertionError(f"[K3b] {what} off by {(err / mag).max().item():.3e} "
                                 "of the sum of |terms|")
        errs.append((err.max().item(), (err / mag).max().item()))
        del term
    del daf, dx_k, dx_p
    xs, ss, ts = (t.detach().clone().requires_grad_(True) for t in (x, scale, shift))
    y_stock = pool_fused.max_pool_bn_relu_reference(xs, ss, ts)
    bwd = dict(shape=list(shape), max_abs_err=max(e for e, _ in errs),
               reduction_err_of_abs_sum=max(r for _, r in errs),
               ms=device_ms("K3b", [lambda: pool_fused.pool_bn_relu_bwd(
                   g, x, scale, shift)]),
               call_ms=median_ms(lambda: pool_fused.pool_bn_relu_bwd(g, x, scale, shift), 20),
               ms_nchw=device_ms("K3b NCHW g", [lambda: pool_fused.pool_bn_relu_bwd(
                   g_nchw, x, scale, shift)]),
               call_ms_nchw=median_ms(lambda: pool_fused.pool_bn_relu_bwd(
                   g_nchw, x, scale, shift), 20),
               plain_ms=median_ms(lambda: pool_fused.pool_bn_relu_bwd_reference(
                   g, x, scale, shift), 5, warmup=1),
               stock_ms=median_ms(lambda: torch.autograd.grad(
                   y_stock, (xs, ss, ts), g, retain_graph=True), 10))
    # per input element: a_pre, the ReLU backward, dx, two sums; per output:
    # the 9-tap max and argmax recomputed (multiply, add, compare each)
    bwd["bound_ms"], bwd["bound_by"] = bound(
        2 * n_out + 4 * n_in + 4 * c * 4, 7 * n_in + 27 * n_out)
    say(f"[K3b] pool_bn_relu_bwd bf16 g {[b, c, h // 2, w]}: dx bit-equal to the "
        f"plain version; dscale max|err| {errs[0][0]:.3e} ({errs[0][1]:.3e} of the "
        f"sum of |terms|), dshift {errs[1][0]:.3e} ({errs[1][1]:.3e}; bar "
        f"{POOL_RED_REL}); two calls, and g channels-last or NCHW, bit-equal; "
        f"kernel {bwd['ms']:.4f} ms device a launch, one call {bwd['call_ms']:.4f} "
        f"(g NCHW, the step's layout, {bwd['ms_nchw']:.4f} device, one call "
        f"{bwd['call_ms_nchw']:.4f} ms), plain {bwd['plain_ms']:.4f} "
        f"ms, the stock ops' backward (context, no single library call) "
        f"{bwd['stock_ms']:.4f} ms, bound {bwd['bound_ms']:.4f} ms by "
        f"{bwd['bound_by']}")
    out["pool_bn_relu_fwd"], out["pool_bn_relu_bwd"] = fwd, bwd
    del x, g, g_nchw, xs, y_stock
    out["pool_tail"] = {c: tail_pool_case(c, device) for c in TAIL_CHANNELS}
    return out


def tail_pool_case(c, device):
    """K3f and K3b at the entry site of an embed-4C model, C % 8 != 0: held
    against their plain versions (y and dx bit for bit, the sums at
    POOL_RED_REL), timed with the padded copies included, beside the same
    site at the padded width."""
    b, _, h, w = STEM_SITES[0][1]
    cp = -(-c // 8) * 8
    x = stem_input((b, c, h, w), device, seed=c)
    gen = torch.Generator(device=device).manual_seed(c + 1)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=device)
    shift = 0.1 * torch.randn(c, generator=gen, device=device)
    g = torch.randn((b, c, h // 2, w), generator=gen, device=device).to(torch.bfloat16)
    y = pool_fused.pool_bn_relu_fwd(x, scale, shift)
    dx, ds, dt = pool_fused.pool_bn_relu_bwd(g, x, scale, shift)
    torch.cuda.synchronize()
    if not torch.equal(y, pool_fused.max_pool_bn_relu_reference(x, scale, shift)):
        raise AssertionError(f"[K3f C{c}] kernel and plain version differ")
    dx_p, ds_p, dt_p = pool_fused.pool_bn_relu_bwd_reference(g, x, scale, shift)
    if not torch.equal(dx, dx_p):
        raise AssertionError(f"[K3b C{c}] dx: kernel and plain version differ")
    daf = pool_fused.routed_grad_reference(g, x, scale, shift)
    err = 0.0
    for what, got, want, term in (("dscale", ds, ds_p, daf * x.float()),
                                  ("dshift", dt, dt_p, daf)):
        mag = term.abs().sum((0, 2, 3))
        e = (got - want).abs()
        if not (e <= POOL_RED_REL * mag + 1e-6).all():
            raise AssertionError(f"[K3b C{c}] {what} off by {(e / mag).max().item():.3e} "
                                 "of the sum of |terms|")
        err = max(err, e.max().item())
    del daf, dx, dx_p, y
    xp = stem_input((b, cp, h, w), device, seed=cp)
    sp, tp = F.pad(scale, (0, cp - c)), F.pad(shift, (0, cp - c))
    gp = torch.randn((b, cp, h // 2, w), device=device).to(torch.bfloat16)
    n_in, n_out = x.numel(), g.numel()
    rec = {"pool_bn_relu_fwd": dict(
        max_abs_err=0.0,
        ms=device_ms(f"K3f C{c}", [lambda: pool_fused.pool_bn_relu_fwd(x, scale, shift)]),
        aligned_ms=device_ms(f"K3f C{cp}", [lambda: pool_fused.pool_bn_relu_fwd(xp, sp, tp)]),
        plain_ms=median_ms(lambda: pool_fused.max_pool_bn_relu_reference(
            x, scale, shift), 5, warmup=1)), "pool_bn_relu_bwd": dict(
        max_abs_err=err,
        ms=device_ms(f"K3b C{c}", [lambda: pool_fused.pool_bn_relu_bwd(g, x, scale, shift)]),
        aligned_ms=device_ms(f"K3b C{cp}", [lambda: pool_fused.pool_bn_relu_bwd(
            gp, xp, sp, tp)]),
        plain_ms=median_ms(lambda: pool_fused.pool_bn_relu_bwd_reference(
            g, x, scale, shift), 3, warmup=1))}
    rec["pool_bn_relu_fwd"]["bound_ms"], rec["pool_bn_relu_fwd"]["bound_by"] = bound(
        2 * n_in + 2 * n_out + 2 * c * 4, 3 * n_in + 8 * n_out)
    rec["pool_bn_relu_bwd"]["bound_ms"], rec["pool_bn_relu_bwd"]["bound_by"] = bound(
        2 * n_out + 4 * n_in + 4 * c * 4, 7 * n_in + 27 * n_out)
    for name, r in rec.items():
        r["shape"] = [b, c, h, w]
        say(f"[K3{name[13]} C{c}] {name} bf16 {[b, c, h, w]} (C % 8 != 0: copies padded "
            f"to {cp} channels{', g NCHW' if name.endswith('bwd') else ''}): y/dx bit-equal "
            f"to the plain version, max|err| {r['max_abs_err']:.3e}; "
            f"{r['ms']:.4f} ms device a launch with the copies, {r['aligned_ms']:.4f} ms at "
            f"C = {cp} (no copy), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
    return rec


# ---------------------------------------------------------------------------
def _held(what, got, want, mag, ulp_rel):
    """max |got - want| and its largest share of the bar ``CONV_SUM_REL *
    mag + ulp_rel * max(|got|, |want|)``; raises past the bar."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bar = CONV_SUM_REL * mag + ulp_rel * torch.maximum(got.abs(), want.abs())
    share = (err / bar.clamp_min(1e-30)).max().item()
    if not share <= 1.0:
        raise AssertionError(f"{what}: kernel and plain version differ by "
                             f"{share:.3f} of the bar")
    return err.max().item(), share


def conv_site_inputs(shape, device):
    """bf16 channels-last x and g, a He-scaled bf16 weight and folded BN
    terms at a stride-1 conv site (C -> C)."""
    b, c, h, w = shape
    x = stem_input(shape, device, seed=c)
    g = stem_input(shape, device, seed=c + 1)
    gen = torch.Generator(device=device).manual_seed(c + 2)
    k = (torch.randn((c, c, 3, 3), generator=gen, device=device)
         * math.sqrt(2.0 / (9 * c))).to(torch.bfloat16)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=device)
    shift = 0.2 * torch.randn(c, generator=gen, device=device)
    return x, g, k, scale, shift


def check_conv_site(name, x, g, k, scale, shift, prologue):
    """K4f/K4d/K4w against their plain versions, and two calls bit-equal.
    Returns the largest |err| and bar share of each kernel."""
    s, t = (scale, shift) if prologue else (None, None)
    runs = [(conv_fused.conv3x3_bn_relu_fwd(x, k, s, t),
             conv_fused.conv3x3_bn_relu_dgrad(g, k, x, s, t),
             conv_fused.conv3x3_bn_relu_wgrad(x, g, s, t)) for _ in range(2)]
    torch.cuda.synchronize()
    (y, (dx, ds, dt), dk), (y2, d2, dk2) = runs
    if not (torch.equal(y, y2) and torch.equal(dk, dk2)
            and all(torch.equal(a, b) for a, b in zip((dx, ds, dt), d2))):
        raise AssertionError(f"[K4 {name}] two calls gave different bits")
    del runs, y2, d2, dk2
    xn = conv_fused._prologue(x, scale, shift) if prologue else x
    kf = k.float()
    errs = {}
    mag = F.conv2d(xn.float().abs(), kf.abs(), padding=1)
    errs["fwd"] = _held(f"[K4f {name}] y", y, conv_fused.conv3x3_bn_relu_reference(
        x, k, s, t), mag, BF16_ULP_REL)
    del mag, y
    dx_p, ds_p, dt_p = conv_fused.conv3x3_dgrad_reference(g, k, x, s, t, prologue)
    mag = torch.nn.grad.conv2d_input(tuple(x.shape), kf.abs(), g.float().abs(), padding=1)
    if prologue:
        mag = mag * scale.abs().view(1, -1, 1, 1)
    e_dx = _held(f"[K4d {name}] dx", dx, dx_p, mag, BF16_ULP_REL)
    del mag, dx, dx_p
    e_red = (0.0, 0.0)
    if prologue:
        xf = x.float()
        da = torch.nn.grad.conv2d_input(tuple(x.shape), kf, g.float(), padding=1)
        da = torch.where(xf * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1) > 0,
                         da, 0.0)
        e_s = _held(f"[K4d {name}] dscale", ds, ds_p, (da * xf).abs().sum((0, 2, 3)), 0.0)
        e_t = _held(f"[K4d {name}] dshift", dt, dt_p, da.abs().sum((0, 2, 3)), 0.0)
        e_red = (max(e_s[0], e_t[0]), max(e_s[1], e_t[1]))
        del da, xf
    elif ds.any() or dt.any():
        raise AssertionError(f"[K4d {name}] dscale/dshift without a prologue")
    errs["dgrad"] = (max(e_dx[0], e_red[0]), max(e_dx[1], e_red[1]))
    mag = torch.nn.grad.conv2d_weight(xn.float().abs(), tuple(k.shape), g.float().abs(),
                                      padding=1)
    errs["wgrad"] = _held(f"[K4w {name}] dk", dk, conv_fused.conv3x3_wgrad_reference(
        x, g, s, t, prologue), mag, 0.0)
    return errs


# The stock eager chains that compute each K4 kernel's function with the
# prologue (``stock_ms``).
STOCK = {"fwd": "two calls (eager prologue + F.conv2d)",
         "dgrad": "chain (conv2d_input + eager strict mask, dx and the two sums)",
         "wgrad": "two calls (eager prologue + conv2d_weight)"}


def dgrad_stock_chain(g, k, x, scale, shift):
    """K4d's function with the prologue as stock eager calls: cuDNN's input
    gradient in the working dtype, then the strict mask from ``x * scale +
    shift > 0``, ``dx = T(da' * scale)`` and the two per-channel sums."""
    c = (1, -1, 1, 1)
    da = torch.nn.grad.conv2d_input(tuple(x.shape), k, g, padding=1).float()
    xf = x.float()
    da = torch.where(xf * scale.view(c) + shift.view(c) > 0, da, 0.0)
    return (da * scale.view(c)).to(x.dtype), (da * xf).sum((0, 2, 3)), da.sum((0, 2, 3))


def timed(what, key, fn, reps=10):
    """{ms<key>: device time a launch, call_ms<key>: one call} of ``fn``;
    a ``key`` ending in "_" is a prefix ("library_" -> library_ms)."""
    ms, call = device_ms(what, [fn]), median_ms(fn, reps)
    if key.endswith("_"):
        return {f"{key}ms": ms, f"{key}call_ms": call}
    return {f"ms{key}": ms, f"call_ms{key}": call}


def phase_conv_kernels(device):
    """K4f, K4d and K4w at the three stride-1 conv sites, with and without
    the prologue, against their plain versions; CUDA-event times of kernel,
    plain version and cuDNN alone (on the pre-normalised tensor), bounds."""
    out = {"conv3x3_bn_relu_fwd": {}, "conv3x3_bn_relu_dgrad": {},
           "conv3x3_bn_relu_wgrad": {}}
    for name, shape in CONV_SITES:
        b, c, h, w = shape
        x, g, k, scale, shift = conv_site_inputs(shape, device)
        errs = {pro: check_conv_site(name, x, g, k, scale, shift, pro)
                for pro in (True, False)}
        xn = conv_fused._prologue(x, scale, shift)
        n = x.numel()
        n_ops = 2 * b * h * w * 9 * c * c
        fwd = dict(
            **timed(f"K4f {name}", "", lambda: conv_fused.conv3x3_bn_relu_fwd(
                x, k, scale, shift)),
            **timed(f"K4f {name} bare", "_bare", lambda: conv_fused.conv3x3_bn_relu_fwd(
                x, k)),
            plain_ms=median_ms(lambda: conv_fused.conv3x3_bn_relu_reference(
                x, k, scale, shift), 10),
            **timed(f"K4f {name} F.conv2d", "library_", lambda: F.conv2d(
                xn, k, padding=1)),
            stock_ms=median_ms(lambda: F.conv2d(conv_fused._prologue(x, scale, shift), k,
                                                padding=1), 10))
        fwd["bound_ms"], fwd["bound_by"] = bound(
            2 * n + 2 * n + 2 * k.numel() + 2 * c * 4, n_ops, BF16_TENSOR_OPS_PER_S)
        dgrad = dict(
            **timed(f"K4d {name}", "", lambda: conv_fused.conv3x3_bn_relu_dgrad(
                g, k, x, scale, shift)),
            **timed(f"K4d {name} bare", "_bare", lambda: conv_fused.conv3x3_bn_relu_dgrad(
                g, k, x)),
            plain_ms=median_ms(lambda: conv_fused.conv3x3_dgrad_reference(
                g, k, x, scale, shift, True), 5, warmup=1),
            **timed(f"K4d {name} conv2d_input", "library_", lambda: torch.nn.grad.conv2d_input(
                tuple(x.shape), k, g, padding=1)),
            stock_ms=median_ms(lambda: dgrad_stock_chain(g, k, x, scale, shift), 10))
        dgrad["bound_ms"], dgrad["bound_by"] = bound(
            3 * 2 * n + 2 * k.numel() + 4 * c * 4, n_ops, BF16_TENSOR_OPS_PER_S)
        wgrad = dict(
            **timed(f"K4w {name}", "", lambda: conv_fused.conv3x3_bn_relu_wgrad(
                x, g, scale, shift)),
            **timed(f"K4w {name} bare", "_bare", lambda: conv_fused.conv3x3_bn_relu_wgrad(
                x, g)),
            plain_ms=median_ms(lambda: conv_fused.conv3x3_wgrad_reference(
                x, g, scale, shift, True), 5, warmup=1),
            **timed(f"K4w {name} conv2d_weight", "library_", lambda: torch.nn.grad.conv2d_weight(
                xn, tuple(k.shape), g, padding=1)),
            stock_ms=median_ms(lambda: torch.nn.grad.conv2d_weight(
                conv_fused._prologue(x, scale, shift), tuple(k.shape), g, padding=1), 10))
        wgrad["bound_ms"], wgrad["bound_by"] = bound(
            2 * 2 * n + 4 * k.numel() + 2 * c * 4, n_ops, BF16_TENSOR_OPS_PER_S)
        for key, rec in (("fwd", fwd), ("dgrad", dgrad), ("wgrad", wgrad)):
            rec["max_abs_err"] = max(errs[True][key][0], errs[False][key][0])
            rec["bar_share"] = max(errs[True][key][1], errs[False][key][1])
            rec["shape"] = list(shape)
            out[f"conv3x3_bn_relu_{key}"][name] = rec
            say(f"[K4{key[0]} {name}] conv3x3_bn_relu_{key} bf16 {list(shape)} -> "
                f"{c} channels: two calls bit-equal; vs plain max|err| "
                f"{rec['max_abs_err']:.3e}, {rec['bar_share']:.3f} of the bar; kernel "
                f"{rec['ms']:.4f} ms device a launch with the prologue (one call "
                f"{rec['call_ms']:.4f}), {rec['ms_bare']:.4f} ms without (one call "
                f"{rec['call_ms_bare']:.4f}; like with like: against cuDNN alone); "
                f"plain {rec['plain_ms']:.4f} ms; cuDNN alone"
                f"{'' if key == 'dgrad' else ' on the pre-normalised tensor'} "
                f"{rec['library_ms']:.4f} ms device a launch (one call "
                f"{rec['library_call_ms']:.4f})"
                + (f"; the stock {STOCK[key]} {rec['stock_ms']:.4f} ms (like with "
                   f"like: against the kernel with the prologue)" if "stock_ms" in rec
                   else "")
                + "; bound "
                f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} "
                f"({n_ops / rec['ms'] / 1e9:.1f} TFLOP/s)")
        del x, g, k, xn
    out["conv_tail"] = {c: tail_conv_case(c, device) for c in TAIL_CHANNELS}
    return out


def tail_conv_case(c, device):
    """K4f, K4d and K4w with the prologue at the stage-1 site of an
    embed-4C model (C -> C, C % 8 != 0), held against their plain versions
    at the sites' bars, timed with the padded copies included, beside the
    same site at the padded width."""
    b, _, h, w = CONV_SITES[0][1]
    cp = -(-c // 8) * 8
    x, g, k, scale, shift = conv_site_inputs((b, c, h, w), device)
    errs = check_conv_site(f"C{c}", x, g, k, scale, shift, True)
    xp, gp, kp, sp, tp = conv_site_inputs((b, cp, h, w), device)
    n, n_ops = x.numel(), 2 * b * h * w * 9 * c * c
    calls = {
        "fwd": (lambda: conv_fused.conv3x3_bn_relu_fwd(x, k, scale, shift),
                lambda: conv_fused.conv3x3_bn_relu_fwd(xp, kp, sp, tp),
                lambda: conv_fused.conv3x3_bn_relu_reference(x, k, scale, shift),
                2 * n + 2 * n + 2 * k.numel() + 2 * c * 4),
        "dgrad": (lambda: conv_fused.conv3x3_bn_relu_dgrad(g, k, x, scale, shift),
                  lambda: conv_fused.conv3x3_bn_relu_dgrad(gp, kp, xp, sp, tp),
                  lambda: conv_fused.conv3x3_dgrad_reference(g, k, x, scale, shift, True),
                  3 * 2 * n + 2 * k.numel() + 4 * c * 4),
        "wgrad": (lambda: conv_fused.conv3x3_bn_relu_wgrad(x, g, scale, shift),
                  lambda: conv_fused.conv3x3_bn_relu_wgrad(xp, gp, sp, tp),
                  lambda: conv_fused.conv3x3_wgrad_reference(x, g, scale, shift, True),
                  2 * 2 * n + 4 * k.numel() + 2 * c * 4)}
    out = {}
    for key, (kernel, aligned, plain, n_bytes) in calls.items():
        rec = dict(shape=[b, c, h, w], max_abs_err=errs[key][0], bar_share=errs[key][1],
                   ms=device_ms(f"K4{key[0]} C{c}", [kernel]),
                   aligned_ms=device_ms(f"K4{key[0]} C{cp}", [aligned]),
                   plain_ms=median_ms(plain, 5, warmup=1))
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, n_ops, BF16_TENSOR_OPS_PER_S)
        out[f"conv3x3_bn_relu_{key}"] = rec
        say(f"[K4{key[0]} C{c}] conv3x3_bn_relu_{key} bf16 {[b, c, h, w]} -> {c} "
            f"channels with the prologue (C % 8 != 0: copies padded to {cp}): vs plain "
            f"max|err| {rec['max_abs_err']:.3e}, {rec['bar_share']:.3f} of the bar; "
            f"{rec['ms']:.4f} ms device a launch with the copies, {rec['aligned_ms']:.4f} "
            f"ms at C = {cp} (no copy), plain {rec['plain_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}")
    return out


# ---------------------------------------------------------------------------
def phase_fused_serve(device, stock):
    """The serve phase's weights with ``pool_impl="pallas"``: the same
    requests and labelled eval_step through K3f, equal to the stock stem."""
    cfg = dataclasses.replace(ModelConfig(), pool_impl="pallas")
    model = build_model(cfg, device=device)
    model.load_state_dict(stock["model"].state_dict(), strict=True)
    n_steps = math.ceil(N_IMAGES / BATCH) + 1
    reset_counts()
    texts = transcribe(model, stock["images"], stock["converter"], BATCH)
    out = eval_step(model, stock["test_batch"])
    torch.cuda.synchronize()
    counts = read_counts()
    want = {**dict.fromkeys(COUNTERS, 0), "ctc_alpha": n_steps,
            "pool_bn_relu_fwd": n_steps}
    if counts != want:
        raise AssertionError(f"fused-stem serving launched {counts} for {n_steps} "
                             f"eval_step calls; expected {want}")
    if not torch.equal(out["logits"], stock["logits"]):
        diff = (out["logits"] - stock["logits"]).abs().max().item()
        raise AssertionError(f"fused-stem logits differ from the stock stem's "
                             f"(max |d| {diff})")
    if texts != stock["texts"]:
        raise AssertionError("fused-stem texts differ from the stock stem's")
    x_batch = stock["x_batch"]
    stock_ms = median_ms(lambda: eval_step(stock["model"], x_batch), 10)
    fused_ms = median_ms(lambda: eval_step(model, x_batch), 10)
    fused_ms2 = median_ms(lambda: eval_step(model, x_batch), 10)
    stock_ms2 = median_ms(lambda: eval_step(stock["model"], x_batch), 10)
    say(f"[fused serve] pool_impl=pallas: {len(texts)} texts and the labelled "
        f"eval_step's logits equal the stock stem's bit for bit; launches "
        f"{counts} for {n_steps} eval_step calls; eval_step stock "
        f"{stock_ms:.3f} / {stock_ms2:.3f} ms, fused {fused_ms:.3f} / "
        f"{fused_ms2:.3f} ms (stock, fused, fused, stock)")
    return counts


def phase_fully_fused_serve(device, stock):
    """The serve phase's weights with all three stem switches: the same
    requests and labelled eval_step through K4f and K3f; the kernels sum in
    another order than cuDNN, so the logits are held to the stock ones by
    frame argmax."""
    cfg = dataclasses.replace(ModelConfig(), **FULLY_FUSED)
    model = build_model(cfg, device=device)
    model.load_state_dict(stock["model"].state_dict(), strict=True)
    n_steps = math.ceil(N_IMAGES / BATCH) + 1
    reset_counts()
    texts = transcribe(model, stock["images"], stock["converter"], BATCH)
    out = eval_step(model, stock["test_batch"])
    torch.cuda.synchronize()
    counts = read_counts()
    want = {**dict.fromkeys(COUNTERS, 0),
            **{k: n * n_steps for k, n in per_eval_launches(FULLY_FUSED).items()}}
    if counts != want:
        raise AssertionError(f"fully fused serving launched {counts} for {n_steps} "
                             f"eval_step calls; expected {want}")
    logits, ref = out["logits"], stock["logits"]
    if tuple(logits.shape) != tuple(ref.shape) or not torch.isfinite(logits).all():
        raise AssertionError(f"fully fused logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    dmax = (logits - ref).abs().max().item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    same_texts = sum(a == b for a, b in zip(texts, stock["texts"]))
    say(f"[fully fused serve] {FULLY_FUSED}: launches {counts} for {n_steps} "
        f"eval_step calls; vs the stock stem's bf16 logits: max |dlogits| "
        f"{dmax:.4f}, frame argmax agreement {agree:.4%} (floor "
        f"{MIN_ARGMAX_AGREEMENT:.0%}); {same_texts} of {len(texts)} texts equal")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"fully fused argmax agreement {agree:.4%} below "
                             f"{MIN_ARGMAX_AGREEMENT:.0%}")
    x_batch = stock["x_batch"]
    stock_ms = median_ms(lambda: eval_step(stock["model"], x_batch), 10)
    fused_ms = median_ms(lambda: eval_step(model, x_batch), 10)
    fused_ms2 = median_ms(lambda: eval_step(model, x_batch), 10)
    stock_ms2 = median_ms(lambda: eval_step(stock["model"], x_batch), 10)
    say(f"[fully fused serve] eval_step stock {stock_ms:.3f} / {stock_ms2:.3f} ms, "
        f"fully fused {fused_ms:.3f} / {fused_ms2:.3f} ms (stock, fused, fused, "
        "stock)")
    return counts, dict(max_dlogits=dmax, argmax_agreement=agree,
                        eval_ms=(fused_ms, fused_ms2), stock_ms=(stock_ms, stock_ms2))


# ---------------------------------------------------------------------------
def flash_inputs(shape, dtype, device, seed):
    """q, k, v [B, H, N, D] as the strided views of a fused qkv projection's
    [B, N, 3, H, D] output (as the model makes them), and a contiguous do;
    N(0, 1) in ``dtype``."""
    b, h, n, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device=device).to(dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    do = torch.randn(shape, generator=gen, device=device).to(dtype)
    return q, k, v, do


def _flash_held(what, got, want):
    """(max |got - want| within FLASH_TOL, its share of the bar, the share
    of elements bit-equal); raises past the bar, and at head_dim past 256
    (the FFMA kernels) in bf16 under FLASH_MIN_EQUAL bit-equal."""
    rtol, of_max = FLASH_TOL[want.dtype]
    equal = (got == want).float().mean().item()
    if want.dtype == torch.bfloat16 and want.shape[-1] > 256 and equal < FLASH_MIN_EQUAL:
        raise AssertionError(f"{what}: {equal:.4f} of the elements bit-equal to the "
                             f"plain version (< {FLASH_MIN_EQUAL})")
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bar = rtol * want.abs() + of_max * want.abs().max()
    share = (err / bar.clamp_min(1e-30)).max().item()
    if not share <= 1.0:
        raise AssertionError(f"{what}: kernel and plain version differ by {share:.3f} "
                             "of the bar")
    return err.max().item(), share, equal


def _sdpa_ms(what, fn):
    """(device time a launch, one call) of an SDPA call in ms, or (None,
    None) where no backend takes the shape (then said so)."""
    try:
        return device_ms(what, [fn]), median_ms(fn, 10)
    except RuntimeError as err:
        say(f"[K5] F.scaled_dot_product_attention: no backend for this call "
            f"({str(err).splitlines()[0][:120]})")
        return None, None


def flash_case(name, shape, backward, dtype, device):
    """K5f (and K5dkv, K5dq) at one shape and dtype against the plain
    versions, two calls bit-equal; times and bounds."""
    b, h, n, d = shape
    q, k, v, do = flash_inputs(shape, dtype, device, seed=n + b)
    scale = d**-0.5
    fa = flash_attn
    runs = [fa.flash_attention_fwd(q, k, v, scale) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(*runs)):
        raise AssertionError(f"[K5f {name}] two calls gave different bits")
    o, l, m = runs[0]
    del runs
    o_p, l_p, m_p = fa.flash_attention_reference(q, k, v, scale)
    rec = {"fwd": {}}
    rec["fwd"]["max_abs_err"], rec["fwd"]["bar_share"], rec["fwd"]["bit_equal"] = (
        _flash_held(f"[K5f {name}] o", o, o_p))
    torch.testing.assert_close(m, m_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=0.0)
    bh_n, size = b * h * n, q.element_size()
    rate = BF16_TENSOR_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    flops = 4 * b * h * n * n * d
    fwd = rec["fwd"]
    fwd.update(**timed(f"K5f {name}", "", lambda: fa.flash_attention_fwd(q, k, v, scale)),
               plain_ms=median_ms(lambda: fa.flash_attention_reference(q, k, v, scale), 5))
    fwd["library_ms"], fwd["library_call_ms"] = _sdpa_ms(
        f"K5f {name} SDPA", lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    fwd["bound_ms"], fwd["bound_by"] = bound(4 * q.numel() * size + 2 * bh_n * 4,
                                             flops, rate)
    del o_p
    if backward:
        di = fa.attention_delta(o, do)
        runs = [(*fa.flash_attention_bwd_dkv(q, k, v, l, m, do, di, scale),
                 fa.flash_attention_bwd_dq(q, k, v, l, m, do, di, scale))
                for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(*runs)):
            raise AssertionError(f"[K5dkv/K5dq {name}] two calls gave different bits")
        dk, dv, dq = runs[0]
        del runs
        dk_p, dv_p = fa.flash_attention_dkv_reference(q, k, v, l, m, do, di, scale)
        e_k, e_v = _flash_held(f"[K5dkv {name}] dk", dk, dk_p), _flash_held(
            f"[K5dkv {name}] dv", dv, dv_p)
        del dk_p, dv_p
        e_q = _flash_held(f"[K5dq {name}] dq", dq, fa.flash_attention_dq_reference(
            q, k, v, l, m, do, di, scale))
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(*leaves, scale=scale).backward(do)

        library, library_call = _sdpa_ms(f"K5 {name} SDPA forward + backward",
                                         sdpa_fwd_bwd)
        library_bwd = library_bwd_call = None
        if library is not None:  # the backward alone: the forward runs outside the window
            out = F.scaled_dot_product_attention(*leaves, scale=scale)
            library_bwd, library_bwd_call = _sdpa_ms(
                f"K5 {name} SDPA backward", lambda: torch.autograd.grad(
                    out, leaves, do, retain_graph=True))
            del out
        io = 4 * q.numel() * size + 3 * bh_n * 4  # q, k, v, do; l, m, di
        libs = dict(library_ms=library, library_call_ms=library_call,
                    library_bwd_ms=library_bwd, library_bwd_call_ms=library_bwd_call)
        rec["dkv"] = dict(
            max_abs_err=max(e_k[0], e_v[0]), bar_share=max(e_k[1], e_v[1]),
            bit_equal=min(e_k[2], e_v[2]),
            **timed(f"K5dkv {name}", "", lambda: fa.flash_attention_bwd_dkv(
                q, k, v, l, m, do, di, scale)),
            plain_ms=median_ms(lambda: fa.flash_attention_dkv_reference(
                q, k, v, l, m, do, di, scale), 3, warmup=1), **libs)
        rec["dkv"]["bound_ms"], rec["dkv"]["bound_by"] = bound(
            io + 2 * q.numel() * size, 2 * flops, rate)
        rec["dq"] = dict(
            max_abs_err=e_q[0], bar_share=e_q[1], bit_equal=e_q[2],
            **timed(f"K5dq {name}", "", lambda: fa.flash_attention_bwd_dq(
                q, k, v, l, m, do, di, scale)),
            plain_ms=median_ms(lambda: fa.flash_attention_dq_reference(
                q, k, v, l, m, do, di, scale), 3, warmup=1), **libs)
        rec["dq"]["bound_ms"], rec["dq"]["bound_by"] = bound(
            io + q.numel() * size, 3 * flops // 2, rate)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    for key, kernel in (("fwd", "K5f"), ("dkv", "K5dkv"), ("dq", "K5dq")):
        if key not in rec:
            continue
        r = rec[key]
        lib = ("none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms")
        if key != "fwd":
            lib += ", backward alone " + ("none" if r["library_bwd_ms"] is None
                                          else f"{r['library_bwd_ms']:.4f} ms")
            if key == "dq" and r["library_bwd_ms"] is not None:
                pair = r["ms"] + rec["dkv"]["ms"]
                lib += (f" (K5dkv + K5dq {pair:.4f} ms, "
                        f"{pair / r['library_bwd_ms']:.2f}x of it)")
        say(f"[{kernel} {name} {tag}] {list(shape)}: two calls bit-equal; vs plain "
            f"max|err| {r['max_abs_err']:.3e}, {r['bar_share']:.3f} of the bar, "
            f"{r['bit_equal']:.2%} bit-equal; kernel "
            f"{r['ms']:.4f} ms device a launch (one call {r['call_ms']:.4f}), plain "
            f"{r['plain_ms']:.4f} ms, SDPA (device a launch) "
            f"{'forward' if key == 'fwd' else 'forward + backward'} {lib}; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
    return rec


def phase_flash_kernels(device):
    """K5f at the serving shapes, K5f/K5dkv/K5dq at the training shapes, in
    bf16 and float32, against their plain versions."""
    out = {}
    for name, shape, backward, dtypes in FLASH_SHAPES:
        for dtype in dtypes:
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            out[f"{name}_{tag}"] = flash_case(name, shape, backward, dtype, device)
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
def selftest_lines(n, rng):
    """Character counts of the JAX serve selftest's ramp (``random_text``
    with ``selftest_max_len``: 4 to 6 + 90 i / (n - 1) characters) and the
    natural widths ``n_chars * 24 + 32`` px."""
    chars = np.array([rng.integers(4, max(5, 6 + (i * 90) // (n - 1)) + 1)
                      for i in range(n)])
    return chars, np.maximum(64, chars * SELFTEST_PX_PER_CHAR + SELFTEST_PAD_PX)


def synthetic_line(i, natural, width):
    """Line i as float32 [64, width, 1]: strokes over its natural width,
    cut at the bucket's width (the widest bucket caps longer lines), white
    after it."""
    rng = np.random.default_rng(SEED + 1000 + i)
    img = np.ones((64, width), np.float32)
    w = min(int(natural), width)
    ink = rng.random((32, w)) < 0.2
    band = img[16:48, :w]
    band[ink] = rng.uniform(0.0, 0.4, int(ink.sum())).astype(np.float32)
    return img[..., None]


def phase_bucket_serve(device, stock):
    """421 lines of the selftest ramp through ``transcribe_buckets`` at
    512/1024/2048 px with the serve phase's weights; K5f counts, per-bucket
    speed and the flash logits against ``attn_impl="xla"``."""
    model, converter = stock["model"], stock["converter"]
    depth = model.cfg.depth
    chars, widths = selftest_lines(N_LINES, np.random.default_rng(SEED + 5))
    buckets = {}
    for w in widths:
        b = next((s for s in SERVE_WIDTHS if w <= s), SERVE_WIDTHS[-1])
        buckets[b] = buckets.get(b, 0) + 1
    batches = {b: math.ceil(n / BATCH) for b, n in buckets.items()}
    wide = sum(n for b, n in batches.items() if b > 512)
    say(f"[bucket serve] {N_LINES} lines of {chars.min()}-{chars.max()} characters, "
        f"{widths.min()}-{widths.max()} px, routed to {SERVE_WIDTHS} at bs {BATCH}: "
        f"lines {buckets}, batches {batches}")

    # --- the main path, counted ------------------------------------------
    load = lambda i, width: synthetic_line(i, widths[i], width)  # noqa: E731
    reset_counts()
    t0 = time.perf_counter()
    texts = transcribe_buckets(model, load, widths, SERVE_WIDTHS, converter, BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    n_steps = sum(batches.values())
    want = {**dict.fromkeys(COUNTERS, 0), "ctc_alpha": n_steps,
            "flash_attention_fwd": depth * wide}
    if counts != want:
        raise AssertionError(f"bucket serving launched {counts}; expected {want}")
    if len(texts) != N_LINES or any(t is None for t in texts):
        raise AssertionError(f"{len(texts)} texts for {N_LINES} lines")
    say(f"[bucket serve] served {N_LINES} lines in {n_steps} eval_step calls in "
        f"{wall:.3f} s (first calls, cuDNN autotune included); launches {counts}")

    # --- per bucket: one eval_step's launches, speed, memory; flash vs xla --
    xla_model = build_model(dataclasses.replace(model.cfg, attn_impl="xla"),
                            device=device)
    xla_model.load_state_dict(model.state_dict(), strict=True)
    rec = {}
    for width in SERVE_WIDTHS:
        rows = [i for i, w in enumerate(widths)
                if next((s for s in SERVE_WIDTHS if w <= s), SERVE_WIDTHS[-1]) == width]
        image = np.ones((BATCH, 64, width, 1), np.float32)
        for j, i in enumerate(rows[:BATCH]):
            image[j] = load(i, width)
        batch = {"image": torch.from_numpy(image).to(device),
                 "labels": torch.zeros((BATCH, SERVE_LMAX), dtype=torch.int32,
                                       device=device),
                 "label_lengths": torch.zeros(BATCH, dtype=torch.int32, device=device)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = eval_step(model, batch)
        torch.cuda.synchronize()
        one = read_counts()
        peak = torch.cuda.max_memory_allocated()
        k5 = depth if width > 512 else 0
        if one != {**dict.fromkeys(COUNTERS, 0), "ctc_alpha": 1, "flash_attention_fwd": k5}:
            raise AssertionError(f"one eval_step at {width} px launched {one}; expected "
                                 f"{k5} K5f and one alpha")
        logits = out["logits"]
        if tuple(logits.shape) != (BATCH, width // 4, model.cfg.nb_cls) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{width} px logits {tuple(logits.shape)}")
        r = dict(lines=buckets.get(width, 0), batches=batches.get(width, 0),
                 k5f_per_eval_step=one["flash_attention_fwd"], peak_mib=peak / 2**20)
        r["eval_ms"] = median_ms(lambda: eval_step(model, batch), 10)
        if width > 512:
            with torch.inference_mode():
                ref = xla_model(batch["image"])
            r["max_dlogits"] = (logits - ref).abs().max().item()
            r["argmax_agreement"] = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
            torch.cuda.reset_peak_memory_stats()
            r["xla_eval_ms"] = median_ms(lambda: eval_step(xla_model, batch), 10)
            r["xla_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
            r["eval_ms_2"] = median_ms(lambda: eval_step(model, batch), 10)
            del ref
        r["img_s"] = BATCH / r["eval_ms"] * 1e3
        say(f"[bucket serve {width}] {r['lines']} lines in {r['batches']} batches; "
            f"{r['k5f_per_eval_step']} K5f per eval_step; eval_step {r['eval_ms']:.3f} "
            f"ms ({r['img_s']:.1f} img/s), peak memory {r['peak_mib']:.1f} MiB"
            + ("" if width == 512 else
               f"; attn_impl=xla on the same weights: eval_step {r['xla_eval_ms']:.3f}"
               f" ms (flash again {r['eval_ms_2']:.3f} ms), peak {r['xla_peak_mib']:.1f}"
               f" MiB; frame argmax agreement {r['argmax_agreement']:.4%} (floor "
               f"{MIN_ARGMAX_AGREEMENT:.0%}), max |dlogits| {r['max_dlogits']:.4f}"))
        if width > 512 and r["argmax_agreement"] < MIN_ARGMAX_AGREEMENT:
            raise AssertionError(f"flash vs xla argmax agreement at {width} px "
                                 f"{r['argmax_agreement']:.4%}")
        rec[width] = r
        del batch, out, logits
    del xla_model
    return counts, rec


# ---------------------------------------------------------------------------
def wide_batch(n, width, rng, device):
    """n line images at ``width`` px with labels of length 1 to the
    recipe's maximum at that width (S up to 2 * 112 + 1 = 225 at 2048)."""
    lmax = WIDE_LMAX[width]
    labels = rng.integers(1, ModelConfig().nb_cls, (n, lmax)).astype(np.int32)
    lengths = rng.integers(1, lmax + 1, n).astype(np.int32)
    labels[np.arange(lmax)[None] >= lengths[:, None]] = 0
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {"image": put(line_images(n, rng, width)), "labels": put(labels),
            "label_lengths": put(lengths)}


def phase_wide_train(device):
    """The multi-width recipe's SAM step at 1024 and 2048 px, bs 64, one
    TrainState; K5 launches per step, speed and memory per width; EMA
    validate at 2048; a learning check at 2048."""
    model_cfg = ModelConfig(masking=MaskConfig(mode="span", ratio=0.4,
                                               max_span_length=8))
    cfg = ExperimentConfig(model=model_cfg, optim=OptimConfig())
    state = create_train_state(cfg, device,
                               torch.Generator(device=device).manual_seed(SEED + 6))
    rng = np.random.default_rng(SEED + 7)
    widths = (1024, 2048)
    batches = {w: wide_batch(WIDE_BATCH, w, rng, device) for w in widths}
    depth = model_cfg.depth
    per_step = {**dict.fromkeys(COUNTERS, 0), "ctc_alpha": 2, "ctc_beta": 2,
                "flash_attention_fwd": 2 * depth, "flash_attention_bwd_dkv": 2 * depth,
                "flash_attention_bwd_dq": 2 * depth}
    say(f"[wide train] HTRVT flagship {model_cfg.compute_dtype}, span masking ratio "
        f"0.4 span 8, SAM + AdamW (OptimConfig()), one TrainState, bs {WIDE_BATCH}, "
        f"{WIDE_STEPS} steps alternating {widths} px, labels up to "
        f"{[WIDE_LMAX[w] for w in widths]} characters")

    # --- the main path, counted ------------------------------------------
    torch.cuda.synchronize()
    reset_counts()
    times = {w: [] for w in widths}
    peaks, losses = {}, []
    for i in range(WIDE_STEPS):
        w = widths[i % 2]
        before = read_counts()
        if i >= WIDE_STEPS - 2:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = train_step(state, batches[w])
        end.record()
        end.synchronize()
        times[w].append(start.elapsed_time(end))
        if i >= WIDE_STEPS - 2:
            peaks[w] = torch.cuda.max_memory_allocated()
        after = read_counts()
        step = {k: after[k] - before[k] for k in after}
        if step != per_step:
            raise AssertionError(f"a train step at {w} px launched {step}; expected "
                                 f"{per_step}")
        losses.append({k: v.item() for k, v in metrics.items()})
    launches = read_counts()
    for m in losses:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite train metrics: {m}")
    rec = {}
    for w in widths:
        ms = statistics.median(times[w][1:])  # the first step of a width warms up
        rec[w] = dict(ms=ms, img_s=WIDE_BATCH / ms * 1e3, first_ms=times[w][0],
                      min_ms=min(times[w][1:]), peak_mib=peaks[w] / 2**20)
        say(f"[wide train {w}] {len(times[w]) - 1} steps after 1 warm-up: median "
            f"{ms:.3f} ms/step ({rec[w]['img_s']:.1f} img/s; min {rec[w]['min_ms']:.3f}"
            f", first {times[w][0]:.3f}), peak memory {rec[w]['peak_mib']:.1f} MiB")
    say(f"[wide train] launches {launches} ({per_step['flash_attention_fwd']} K5f, "
        f"K5dkv and K5dq, 2 alpha and 2 beta per step); loss "
        + " ".join(f"{m['loss']:.3f}" for m in losses))

    # --- EMA validation at 2048 px: 4 K5f and 1 alpha per batch -------------
    alphabet = [chr(c) for c in range(33, 33 + model_cfg.nb_cls - 1)]
    converter = CTCLabelConverter(alphabet)
    val, val_rows = [], (WIDE_BATCH, WIDE_BATCH - 5)
    for n_valid in val_rows:
        b = wide_batch(WIDE_BATCH, 2048, rng, device)
        labels, lengths = b["labels"].cpu().numpy(), b["label_lengths"].cpu().numpy()
        texts = ["".join(alphabet[c - 1] for c in row[:n])
                 for row, n in zip(labels[:n_valid], lengths[:n_valid])]
        val.append((b, n_valid, texts))
    reset_counts()
    val_loss, cer, wer, preds, _ = validate(state.ema_model, val, converter)
    val_launches = read_counts()
    want = {**dict.fromkeys(COUNTERS, 0), "ctc_alpha": 2,
            "flash_attention_fwd": 2 * depth}
    if val_launches != want:
        raise AssertionError(f"validate at 2048 px launched {val_launches}; expected "
                             f"{want}")
    if not math.isfinite(val_loss) or len(preds) != sum(val_rows):
        raise AssertionError(f"validate: loss {val_loss}, {len(preds)} predictions")
    say(f"[wide train] EMA validate at 2048 px over 2 batches ({len(preds)} valid "
        f"rows): loss {val_loss:.4f}, CER {cer:.4f}, WER {wer:.4f}; launches "
        f"{val_launches}")
    launches = {k: n + val_launches[k] for k, n in launches.items()}
    del state, batches

    # --- learning check at 2048 px ------------------------------------------
    learn = create_train_state(
        dataclasses.replace(cfg, optim=OptimConfig(max_lr=3e-4, warmup_iters=5)),
        device, torch.Generator(device=device).manual_seed(SEED + 8))
    small = wide_batch(LEARN_BATCH, 2048, np.random.default_rng(SEED + 9), device)
    curve = [train_step(learn, small)["loss"].item() for _ in range(LEARN_STEPS)]
    say(f"[wide train] learning check, {LEARN_STEPS} steps on one batch of "
        f"{LEARN_BATCH} at 2048 px (max_lr 3e-4, warmup 5): pass-1 loss "
        f"{curve[0]:.4f} -> {curve[-1]:.4f}")
    if not curve[-1] < curve[0]:
        raise AssertionError(f"no learning at 2048 px: {curve}")
    rec["learn"] = (curve[0], curve[-1])
    return launches, rec


# ---------------------------------------------------------------------------
class LineSet:
    """Seeded in-memory lines for ``fit`` on a machine that cannot render or
    read line images (no cv2, no PIL): uint8 [64, 512] "handwriting"
    (``line_images``) with random texts of 1-96 characters of ``alphabet``,
    as ``train_batch`` labels them."""

    def __init__(self, n, alphabet, seed):
        rng = np.random.default_rng(seed)
        self.images = np.uint8(np.clip(line_images(n, rng)[..., 0] * 255.0, 0, 255))
        self.alphabet = sorted(alphabet)
        self.labels = ["".join(alphabet[i] for i in rng.integers(0, len(alphabet), m))
                       for m in rng.integers(1, LMAX + 1, n)]

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]


def _fit_cfg(out_dir, exp_name, total, resume=None):
    """The flagship, fully fused, with the IAM recipe's span masking and
    ``OptimConfig()``, at bs 128, augmentation off (no cv2 on the card)."""
    model_cfg = ModelConfig(masking=MaskConfig(mode="span", ratio=0.4, max_span_length=8),
                            **FULLY_FUSED)
    return ExperimentConfig(
        model=model_cfg, optim=OptimConfig(),
        data=DataConfig(train_bs=BATCH, val_bs=BATCH, num_workers=4,
                        augment=AugmentConfig(enable=False)),
        train=TrainConfig(out_dir=out_dir, exp_name=exp_name, seed=SEED,
                          total_iters=total, eval_iters=FIT_EVAL, print_iters=FIT_PRINT,
                          resume=resume, keep_checkpoints=2))


def _recorded_fit(cfg, datasets, device):
    """``loop.fit`` with each step's pass-1 loss kept (device scalars, read
    after the run)."""
    losses = []

    def recording(state, batch):
        metrics = train_step(state, batch)
        losses.append(metrics["loss"])
        return metrics

    loop.train_step = recording
    try:
        result = loop.fit(cfg, device=device, datasets=datasets)
    finally:
        loop.train_step = train_step
    return result, [float(v) for v in losses]


def _final_state(run_dir, step):
    mgr = CheckpointManager(run_dir)
    path = dict((s, os.path.join(run_dir, n)) for s, n in mgr.list_rolling())[step]
    return mgr.read(path)[0]


def _train(tmp, name, datasets, device, keep=False):
    """``fit`` to FIT_STEPS in run directory ``name`` -> (pass-1 losses, the
    final state file's contents); the directory is removed unless ``keep``."""
    _, losses = _recorded_fit(_fit_cfg(tmp, name, FIT_STEPS), datasets, device)
    state = _final_state(os.path.join(tmp, name), FIT_STEPS)
    if not keep:
        shutil.rmtree(os.path.join(tmp, name))
    return losses, state


def _train_resumed(tmp, name, datasets, device):
    """``fit`` to FIT_SPLIT, then ``resume="auto"`` to FIT_STEPS, in run
    directory ``name`` -> (pass-1 losses of both legs, the final state)."""
    _, first = _recorded_fit(_fit_cfg(tmp, name, FIT_SPLIT), datasets, device)
    _, resumed = _recorded_fit(_fit_cfg(tmp, name, FIT_STEPS, resume="auto"),
                               datasets, device)
    run_dir = os.path.join(tmp, name)
    with open(os.path.join(run_dir, "run.log")) as f:
        if f"resumed at step {FIT_SPLIT}" not in f.read():
            raise AssertionError(f"[fit] {name}: the second run did not resume at step "
                                 f"{FIT_SPLIT}")
    state = _final_state(run_dir, FIT_STEPS)
    shutil.rmtree(run_dir)
    return first + resumed, state


def fixed_order_class_sum(dlp, z, num_classes):
    """``ctc_cuda.class_sum`` in a fixed order: the states' gradients times
    their classes' one-hot rows, one float64 batched GEMM (each class's
    states added in the same order every run), rounded to float32."""
    onehot = F.one_hot(z.long(), num_classes).to(torch.float64)  # [B, S, C]
    return torch.bmm(dlp.double(), onehot).float()


class deterministic_algorithms:
    """``torch.use_deterministic_algorithms(True)`` inside the block, with
    the cuBLAS workspace setting it asks for (read at each call), restored
    after."""

    def __enter__(self):
        self._env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        if self._env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = self._env


class fixed_order_ctc:
    """Inside the block the CTC glue's class sum is ``fixed_order_class_sum``;
    nothing else changes."""

    def __enter__(self):
        ctc_cuda.class_sum = fixed_order_class_sum

    def __exit__(self, *exc):
        ctc_cuda.class_sum = CLASS_SUM


CLASS_SUM = ctc_cuda.class_sum


def compare_states(got, want, got_losses, want_losses):
    """Two runs' final state files and pass-1 losses: bit_equal; the largest
    relative loss gap; for the model, the EMA model and the AdamW moments the
    largest |gap|, the L2 norm of the gap over the state's (``*_l2``), and
    the largest |gap| of a leaf over the leaf's largest |value| (``*_leaf``,
    with the leaf that has it)."""
    def leaves(state):
        for key in ("model", "ema_model"):
            for k, v in state[key].items():
                yield key, k, v
        for i, st in state["optimizer"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq", "step"):
                yield "adamw", f"{i}.{k}", st[k]

    out = {"losses_rel": max(abs(a - b) / abs(b) for a, b in zip(got_losses, want_losses)),
           "step": (got["step"], want["step"]),
           "generator_equal": torch.equal(got["generator"], want["generator"])}
    sums = {}
    for (part, name, a), (_, _, b) in zip(leaves(got), leaves(want)):
        a, b = a.double(), b.double()
        gap = (a - b).abs().max().item() if a.numel() else 0.0
        scale = b.abs().max().item() if b.numel() else 0.0
        share = gap / scale if scale else (0.0 if gap == 0 else math.inf)
        out[part] = max(out.get(part, 0.0), gap)
        if share >= out.get(f"{part}_leaf", (-1.0,))[0]:
            out[f"{part}_leaf"] = (share, name)
        d2, b2 = sums.get(part, (0.0, 0.0))
        sums[part] = (d2 + (a - b).square().sum().item(), b2 + b.square().sum().item())
    for part, (d2, b2) in sums.items():
        out[f"{part}_l2"] = math.sqrt(d2 / b2) if b2 else (0.0 if d2 == 0 else math.inf)
    out["bit_equal"] = (got_losses == want_losses and got["step"] == want["step"]
                        and out["generator_equal"]
                        and out["model"] == out["ema_model"] == out["adamw"] == 0.0)
    return out


def within_bars(held):
    """Whether a default-mode comparison (``compare_states``) is inside
    FIT_LOSS_REL, FIT_STATE_L2 and FIT_LEAF_SHARE, with equal steps and
    generators."""
    return (held["losses_rel"] <= FIT_LOSS_REL and held["generator_equal"]
            and held["step"][0] == held["step"][1]
            and all(held[f"{p}_l2"] <= bar and held[f"{p}_leaf"][0] <= FIT_LEAF_SHARE
                    for p, bar in FIT_STATE_L2.items()))


def gaps(held):
    """A comparison's gaps, for a printed line."""
    return (f"losses {held['losses_rel']:.3e} (rel), "
            + ", ".join(f"{p} {held[p]:.3e} max, {held[p + '_l2']:.3e} of its L2 norm, "
                        f"leaf {held[p + '_leaf'][1]} {held[p + '_leaf'][0]:.3e} of its "
                        "largest value" for p in ("model", "ema_model", "adamw")))


def phase_fit(device, smi_line):
    """``htr_vt_torch.train.loop.fit`` at the flagship's full width with the
    fully fused stem: 6 steps uninterrupted (kernel launches counted, img/s,
    peak memory); in default mode, "train 3, resume, train 3" held against
    it at FIT_LOSS_REL, FIT_STATE_L2 and FIT_LEAF_SHARE; under deterministic algorithms,
    "train 6" and "train 3, resume, train 3" held bit for bit, and the
    default-mode run held against them at the bars; in default mode with
    only the CTC class sum in a fixed order, "train 6" against "train 3,
    resume, train 3"; best_CER served through ``cli/serve.py``'s checkpoint
    route."""
    alphabet = [chr(c) for c in range(33, 33 + ModelConfig().nb_cls - 1)]
    train_ds, val_ds = (LineSet(n, alphabet, SEED + 20 + i) for i, n in enumerate(FIT_LINES))
    datasets = (train_ds, val_ds)
    n_val = math.ceil(FIT_LINES[1] / BATCH)
    n_evals = FIT_STEPS // FIT_EVAL
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_", dir=root)
    say(f"[fit] loop.fit: flagship fully fused bf16, bs {BATCH}, {FIT_LINES[0]} train and "
        f"{FIT_LINES[1]} val seeded in-memory lines (labels of 1-{LMAX} characters); "
        f"augmentation off (cv2 is not on this machine); total_iters {FIT_STEPS}, "
        f"eval_iters {FIT_EVAL}, print_iters {FIT_PRINT}; checkpoints under {tmp}")
    try:
        # --- the main path, counted ------------------------------------------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        full, full_losses = _recorded_fit(_fit_cfg(tmp, "full", FIT_STEPS), datasets,
                                             device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        per_step, per_val = per_step_launches(FULLY_FUSED), per_eval_launches(FULLY_FUSED)
        want = {k: FIT_STEPS * per_step.get(k, 0) + n_evals * n_val * per_val.get(k, 0)
                for k in COUNTERS}
        if launches != want:
            raise AssertionError(f"[fit] launches {launches}; {FIT_STEPS} steps and "
                                 f"{n_evals} x {n_val} eval batches make {want}")
        if not np.isfinite(full_losses).all() or len(full_losses) != FIT_STEPS:
            raise AssertionError(f"[fit] losses {full_losses}")
        full_dir = os.path.join(tmp, "full")
        with open(os.path.join(full_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        rates = [r["train/imgs_per_sec"] for r in records if "train/imgs_per_sec" in r]
        vals = [(r["val/CER"], r["val/WER"]) for r in records if "val/CER" in r]
        say(f"[fit] {FIT_STEPS} steps + {n_evals} evals in {wall:.3f} s (build, cuDNN "
            f"warm-up, loader and checkpoints included); best CER {full['best_cer']:.4f} "
            f"WER {full['best_wer']:.4f}; pass-1 losses "
            + " ".join(f"{v:.4f}" for v in full_losses)
            + f"; StepTimer img/s {' '.join(f'{r:.1f}' for r in rates)} (steps 1-3 hold "
            f"the first step's warm-up; steps 4-6 after the eval); val CER/WER {vals}; "
            f"peak memory {peak / 2**20:.1f} MiB; launches {launches} = {FIT_STEPS} x "
            f"{per_step} + {n_evals * n_val} x {per_val}; {smi_line}")
        full_state = _final_state(full_dir, FIT_STEPS)
        bars = (f"bars: losses {FIT_LOSS_REL:.0e} (rel), of each part's L2 norm "
                + ", ".join(f"{p} {bar:.1e}" for p, bar in FIT_STATE_L2.items())
                + f", each leaf {FIT_LEAF_SHARE} of its largest value")

        # --- default mode: train 3, resume, train 3 ----------------------------
        split_losses, split_state = _train_resumed(tmp, "split", datasets, device)
        resume = compare_states(split_state, full_state, split_losses, full_losses)
        say(f"[fit] default mode: train {FIT_SPLIT}, resume (auto), train "
            f"{FIT_STEPS - FIT_SPLIT}: pass-1 losses "
            + " ".join(f"{v:.4f}" for v in split_losses) + " against the uninterrupted "
            f"run's: {'bit-equal' if resume['bit_equal'] else 'not bit-equal'}; "
            f"{gaps(resume)}; {bars}")

        # --- deterministic algorithms: train 6; train 3, resume, train 3 -------
        with deterministic_algorithms():
            det_losses, det_state = _train(tmp, "det", datasets, device)
            det_split_losses, det_split_state = _train_resumed(tmp, "det_split", datasets,
                                                               device)
        held = compare_states(det_split_state, det_state, det_split_losses, det_losses)
        default_det = compare_states(full_state, det_state, full_losses, det_losses)
        say(f"[fit] under torch.use_deterministic_algorithms: train {FIT_STEPS}, and train "
            f"{FIT_SPLIT}, resume (auto), train {FIT_STEPS - FIT_SPLIT}: pass-1 losses "
            + " ".join(f"{v:.4f}" for v in det_split_losses) + " against "
            + " ".join(f"{v:.4f}" for v in det_losses) + ": "
            + ("bit-equal (losses, model, EMA, AdamW, step, generator)"
               if held["bit_equal"] else f"NOT bit-equal: {held}")
            + f"; the default-mode run against the deterministic one: {gaps(default_det)}")
        del det_state, det_split_state

        # --- default mode, only the CTC class sum in a fixed order -------------
        with fixed_order_ctc():
            fixed_losses, fixed_state = _train(tmp, "fixed", datasets, device)
            fixed_split_losses, fixed_split_state = _train_resumed(tmp, "fixed_split",
                                                                   datasets, device)
        fixed = compare_states(fixed_split_state, fixed_state, fixed_split_losses,
                               fixed_losses)
        del fixed_state, fixed_split_state
        say(f"[fit] default mode with only the CTC class sum in a fixed order "
            f"(ops/ctc_cuda.py:class_sum as one float64 one-hot GEMM): train {FIT_STEPS} "
            f"against train {FIT_SPLIT}, resume, train {FIT_STEPS - FIT_SPLIT}: "
            + ("bit-equal (losses, model, EMA, AdamW, step, generator): scatter_add_'s "
               "atomics are what keep default-mode runs apart; cuDNN's default "
               "algorithms reproduce" if fixed["bit_equal"] else
               f"not bit-equal, so more than scatter_add_ differs: {gaps(fixed)}"))
        if not held["bit_equal"]:
            raise AssertionError(f"[fit] the deterministic resumed run differs: {held}")
        if not fixed["bit_equal"]:
            raise AssertionError("[fit] with the CTC class sum in a fixed order the resumed "
                                 f"run differs: {fixed}")
        for name, cmp in (("default-mode resume", resume),
                          ("default-mode run against the deterministic one", default_det)):
            if not within_bars(cmp):
                raise AssertionError(f"[fit] the {name} is outside the bars ({bars}): "
                                     f"{cmp}")

        # --- save and restore times; best_CER through the serve route ------------
        template = create_train_state(_fit_cfg(tmp, "t", FIT_STEPS), device,
                                      torch.Generator(device=device))
        mgr = CheckpointManager(full_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, meta = mgr.restore(os.path.join(full_dir, "best_CER"), template)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        CheckpointManager(os.path.join(tmp, "save")).save(
            template, cer=meta["cer"], wer=meta["wer"], best_cer=meta["cer"],
            best_wer=meta["wer"])
        save_ms = (time.perf_counter() - t0) * 1e3
        served = load_serving_model(os.path.join(full_dir, "best_CER"), None, device)
        batch = train_batch(BATCH, served.cfg, np.random.default_rng(SEED + 30), device)
        got = eval_step(served, batch)["pred_ids"]
        want_ids = eval_step(template.ema_model, batch)["pred_ids"]
        if not torch.equal(got, want_ids):
            raise AssertionError("[fit] the served best_CER frame argmax differs from "
                                 "eval_step on the saved EMA model")
        say(f"[fit] best_CER (step {meta['step']}, CER {meta['cer']:.4f}) served through "
            f"cli/serve.py:load_serving_model at its saved config ({served.cfg.pool_impl} "
            f"pool, {served.cfg.conv_impl} conv): frame argmax equal to eval_step on the "
            f"restored EMA model over {BATCH} lines; checkpoint restore {restore_ms:.1f} ms, "
            f"save {save_ms:.1f} ms (model, EMA, AdamW: "
            f"{os.path.getsize(os.path.join(full_dir, 'best_CER', 'state.pt')) / 2**20:.1f}"
            f" MiB); {smi_line}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, dict(losses=full_losses, resumed_losses=split_losses,
                          deterministic_losses=det_losses,
                          deterministic_resumed_losses=det_split_losses,
                          fixed_order_ctc_losses=fixed_losses,
                          fixed_order_ctc_resumed_losses=fixed_split_losses,
                          default_resume=resume, deterministic_resume=held,
                          default_vs_deterministic=default_det, fixed_order_ctc=fixed,
                          loss_rel_bar=FIT_LOSS_REL, state_l2_bar=FIT_STATE_L2,
                          leaf_share_bar=FIT_LEAF_SHARE,
                          imgs_per_sec=rates, peak=peak, wall_s=wall, save_ms=save_ms,
                          restore_ms=restore_ms)


# ---------------------------------------------------------------------------
def main():
    smi_line, max_sm_mhz = phase_device()
    device = torch.device("cuda", 0)
    build_s = phase_build()
    kernels = phase_kernels(device, max_sm_mhz)
    ctc_long = phase_ctc_long(device)
    stem = phase_stem_kernels(device)
    conv = phase_conv_kernels(device)
    flash = phase_flash_kernels(device)
    serve_launches, stock = phase_serve(device)
    fused_serve = phase_fused_serve(device, stock)
    full_serve, full_serve_rec = phase_fully_fused_serve(device, stock)
    bucket_serve, bucket_rec = phase_bucket_serve(device, stock)
    del stock
    train_launches, train = phase_train(device)
    fused_train, fused = phase_train(device, FUSED, train["first_loss"],
                                     "fused train")
    full_train, full = phase_train(device, FULLY_FUSED, train["first_loss"],
                                   "fully fused train")
    wide_train, wide_rec = phase_wide_train(device)
    fit_launches, fit_rec = phase_fit(device, smi_line)
    say(f"[done] build {build_s:.2f} s; {smi_line}")
    main_path = {k: fused_serve[k] + full_serve[k] + fused_train[k] + full_train[k]
                 + train_launches[k] + bucket_serve[k] + wide_train[k] + fit_launches[k]
                 for k in COUNTERS}
    main_path["ctc_alpha"] += serve_launches
    k193, k17 = kernels["S193"], kernels["S17"]
    entry = stem["bn_stats"]["entry"]
    ctc = [{
        "name": f"ctc_{which}",
        "route": "cuda",
        "source": f"htr_vt_torch/csrc/ctc_{which}.cu",
        "replaces": f"htr_vt_tpu/ops/ctc_pallas.py:{line}",
        "launches": main_path[f"ctc_{which}"],
        "max_abs_err": max(k[f"{which}_err"] for k in kernels.values()),
        "ms": k193[f"{which}_ms"],
        "plain_ms": k193[f"{which}_plain_ms"],
        "bound_ms": k193["bound_ms"],
        "bound_by": k193["bound_by"],
        "library_ms": k193[f"{which}_library_ms"],
        "library": "F.ctc_loss " + ("forward" if which == "alpha"
                                    else "forward + backward"),
        "shape": "B128 T128 C80 S193",
        "call_ms": k193[f"{which}_call_ms"],
        "library_call_ms": k193[f"{which}_library_call_ms"],
        "cycles_a_frame": k193[f"{which}_cycles_a_frame"],
        "max_sm_mhz": max_sm_mhz,
        "cases": {case: {k: v for k, v in rec.items() if not k.startswith(other)}
                  for case, rec in {**kernels, **ctc_long}.items()},
    } for which, other, line in (("alpha", "beta", 55), ("beta", "alpha", 88))]
    stem_lines = [{
        "name": "bn_stats",
        "route": "cuda",
        "source": "htr_vt_torch/csrc/bn_stats.cu",
        "replaces": "htr_vt_tpu/ops/bn_stats.py:35",
        "launches": main_path["bn_stats"],
        "max_abs_err": max(v["max_abs_err"] for v in stem["bn_stats"].values()),
        "ms": entry["ms"],
        "plain_ms": entry["plain_ms"],
        "bound_ms": entry["bound_ms"],
        "bound_by": entry["bound_by"],
        "library_ms": entry["library_ms"],
        "library": "torch.batch_norm_stats",
        "call_ms": entry["call_ms"],
        "library_call_ms": entry["library_call_ms"],
        "shape": "bf16 [128, 192, 32, 512] channels-last (the entry site)",
        "launches_a_call": entry["launches_a_call"],
        "sites": stem["bn_stats"],
        "any_c": stem["bn_stats_any_c"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "htr_vt_torch/csrc/pool_fused.cu",
        "replaces": f"htr_vt_tpu/ops/pool_fused.py:{line}",
        "launches": main_path[name],
        "max_abs_err": stem[name]["max_abs_err"],
        "ms": stem[name]["ms"],
        "plain_ms": stem[name]["plain_ms"],
        "bound_ms": stem[name]["bound_ms"],
        "bound_by": stem[name]["bound_by"],
        "library_ms": None,
        "shape": "bf16 x [128, 192, 32, 512] channels-last",
        **{k: stem[name][k] for k in ("call_ms", "stock_ms", "ms_nchw", "call_ms_nchw")
           if k in stem[name]},
        "tail_c": {c: rec[name] for c, rec in stem["pool_tail"].items()},
    } for name, line in (("pool_bn_relu_fwd", 62), ("pool_bn_relu_bwd", 72))]
    conv_lines = [{
        "name": name,
        "route": "cuda",
        "source": "htr_vt_torch/csrc/conv_fused.cu",
        "replaces": f"htr_vt_tpu/ops/conv_fused.py:{line}",
        "launches": main_path[name],
        "max_abs_err": max(v["max_abs_err"] for v in conv[name].values()),
        "ms": conv[name]["stage1"]["ms"],
        "plain_ms": conv[name]["stage1"]["plain_ms"],
        "bound_ms": conv[name]["stage1"]["bound_ms"],
        "bound_by": conv[name]["stage1"]["bound_by"],
        "library_ms": conv[name]["stage1"]["library_ms"],
        "library": library + " alone on the pre-normalised bf16 tensor (cuDNN)",
        "call_ms": conv[name]["stage1"]["call_ms"],
        "library_call_ms": conv[name]["stage1"]["library_call_ms"],
        "ms_bare": conv[name]["stage1"]["ms_bare"],
        "stock_ms": conv[name]["stage1"]["stock_ms"],
        "stock": stock,
        "shape": "bf16 [128, 192, 8, 512] channels-last, 192 -> 192, with the "
                 "prologue (stage 1)",
        "sites": conv[name],
        "tail_c": {c: rec[name] for c, rec in conv["conv_tail"].items()},
    } for name, line, library, stock in (
        ("conv3x3_bn_relu_fwd", 82, "F.conv2d", "conv_fused._prologue (eager) + F.conv2d"),
        ("conv3x3_bn_relu_dgrad", 230, "torch.nn.grad.conv2d_input",
         "torch.nn.grad.conv2d_input + the eager strict mask, dx and the two sums "
         "(chip_smoke.dgrad_stock_chain)"),
        ("conv3x3_bn_relu_wgrad", 286, "torch.nn.grad.conv2d_weight",
         "conv_fused._prologue (eager) + torch.nn.grad.conv2d_weight"))]
    flash_lines = [{
        "name": name,
        "route": "cuda",
        "source": "htr_vt_torch/csrc/flash_attn.cu",
        "replaces": replaces,
        "launches": main_path[name],
        "max_abs_err": max(r[key]["max_abs_err"] for r in flash.values() if key in r),
        "ms": flash[case][key]["ms"],
        "plain_ms": flash[case][key]["plain_ms"],
        "bound_ms": flash[case][key]["bound_ms"],
        "bound_by": flash[case][key]["bound_by"],
        "library_ms": flash[case][key]["library_ms"],
        "library": "F.scaled_dot_product_attention " + (
            "forward" if key == "fwd" else "forward + backward"),
        "call_ms": flash[case][key]["call_ms"],
        "library_call_ms": flash[case][key]["library_call_ms"],
        **({"library_bwd_ms": flash[case][key]["library_bwd_ms"],
            "library_bwd": "its backward alone (torch.autograd.grad on a graph whose "
                           "forward ran outside the timed window)"}
           if key != "fwd" else {}),
        "shape": shape,
        "cases": {c: r[key] for c, r in flash.items() if key in r},
    } for name, key, case, shape, replaces in (
        ("flash_attention_fwd", "fwd", "serve2048_bf16",
         "bf16 [128, 6, 512, 128] (serving, 2048 px)",
         "jax/experimental/pallas/ops/tpu/flash_attention.py:758 via "
         "htr_vt_tpu/models/vit.py:67"),
        ("flash_attention_bwd_dkv", "dkv", "train2048_bf16",
         "bf16 [64, 6, 512, 128] (training, 2048 px)",
         "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 via "
         "htr_vt_tpu/models/vit.py:67"),
        ("flash_attention_bwd_dq", "dq", "train2048_bf16",
         "bf16 [64, 6, 512, 128] (training, 2048 px)",
         "jax/experimental/pallas/ops/tpu/flash_attention.py:1456 via "
         "htr_vt_tpu/models/vit.py:67"))]
    say(json.dumps({"kernels": ctc + stem_lines + conv_lines + flash_lines,
                    "bucket_serve": bucket_rec, "wide_train": wide_rec,
                    "train_ms": train["ms"], "fused_train_ms": fused["ms"],
                    "fully_fused_train_ms": full["ms"], "train_peak": train["peak"],
                    "fused_train_peak": fused["peak"],
                    "fully_fused_train_peak": full["peak"],
                    "fully_fused_first_loss": full["first_loss"],
                    "stock_first_loss": train["first_loss"],
                    "conv_grad_copies": full["conv_grad_copies"],
                    "pool_grad_copies": fused["grad_copies"] + full["grad_copies"],
                    "fully_fused_serve": full_serve_rec, "fit": fit_rec}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
