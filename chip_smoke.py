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
   it in default mode bit for bit (losses, model, EMA, AdamW, step,
   generator: the CTC class sum runs in a fixed order); under
   ``torch.use_deterministic_algorithms`` the same pair held bit for bit,
   and the default-mode run held against it at stated bars
   (``FIT_LOSS_REL``, ``FIT_STATE_L2``, ``FIT_LEAF_SHARE``); best_CER
   served through ``cli/serve.py:load_serving_model``, its frame argmax
   equal to ``eval_step`` on the restored EMA model; img/s from the loop's
   ``StepTimer``, checkpoint save and restore ms, peak memory. The
   checkpoints live in a temporary directory under the git-ignored
   ``build/``, removed at the end.
15. zoo serve: each block recipe of ``models/variants.py`` (window,
   macaron, macaron_2, localglobal, lgp, lgp_svtr, conformer,
   squeezeformer) at the flagship width (embed 768, heads 6, 64x512, bf16,
   its preset depth), fully fused, seeded weights: one counted
   ``eval_step`` at bs 128 (1 alpha, 1 K3f, 9 K4f) against the same weights
   on the stock ops (``attn_impl="xla"``, stock stem) and in float32: frame
   argmax >= 99% of the float32 one on the frames whose float32 margin the
   stock ops' own bf16 rounding cannot cross (``_zoo_case``), and its
   ``eval_step`` ms and img/s; conformer and
   localglobal again at 2048 px (N = 512), where their global blocks take
   K5f (4 and 2 a call).
16. sgm mms train: ``model_sgm_mms_conv`` (conformer, the SGM head, the
   tri-masked trainer: random .30 / block .20 / span_old .20 forwards a
   pass) at the flagship width, fully fused, SAM + AdamW at bs 128: each
   step launches three times a single-mask step's kernels (K1a/K1b 6, K2
   96, K3f/K3b 6, K4f/K4d/K4w 54); losses, ``loss_sgm``, ``loss_ctc`` and
   the gradient norm finite; ms/step, img/s and peak memory. Then two
   steps at 64x1024 px (bs 64, N = 256): K5f, K5dkv and K5dq 24 each a
   step (4 blocks x 3 forwards x 2 passes).
17. zoo standalone: Swin (its constructor's widths: d_model 192), SVTR
   tiny, and van and van2 behind the flagship trunk, bf16, seeded weights,
   built with the fully fused switches, which reach none of their stems:
   one counted ``eval_step`` at bs 128 and 512 px launches 1 K1a and
   nothing else, its frame argmax held against the same weights in
   float32 on the frames whose float32 margin the bf16 rounding cannot
   cross (``_zoo_case``); Swin and SVTR again at 1024 px (bs 64, their
   per-grid tables); then each recipe's tri-masked SGM SAM steps (MMS
   masking, bs 128): exactly 6 K1a and 6 K1b a step, finite losses,
   ms/step, img/s and peak memory, and a 20-step learning check at bs 16
   whose pass-1 loss must fall.
18. encoder decoder: ``run/train_encoder_decoder_iam.sh`` through the
   port's argument bridge at full width (the flagship trunk fully fused,
   6 decoder layers of 8 heads, ``max_seq_len`` 256, label smoothing 0.1),
   bs 128, on 512 train and 128 val seeded lines with texts of 1-96
   characters (``ed_len`` 98): ``fit`` for 4 steps with an EMA
   ``eval_step_ed`` and a checkpoint every 2, launches exactly 4 x (K2 32,
   K3f/K3b 2, K4f/K4d/K4w 18) + 2 x (1 K3f, 9 K4f), no K1 or K5; "train 2,
   resume, train 2" held bit for bit against it in default mode; then on
   the best_CER EMA model ``eval_step_ed`` (one encode: 1 K3f, 9 K4f),
   greedy and beam (5) generation over 98 positions at bs 128, timed, and
   the cached decode against the uncached ``decode_logits`` at every
   position (bf16: argmax >= 99%; a float32 copy: argmax equal, logits
   within 1e-3).
19. int8 serve: ``ModelConfig(quant="int8")`` (the flagship, stage 1
   padded to 256, quick GELU) on the serve phase's seeded weights through
   ``ops/quant.py:serving_arrays``, calibrated on 4 batches of bs 128
   synthetic lines (``calibrate_quant_stats``). Q1 (``conv_int8_cuda``,
   ``csrc/conv_int8.cu``) against its plain twin at every distinct site
   shape of that forward at bs 128 (s8 input, bf16 input with and without
   the BN prologue, bf16 and float32 out): the s32 accumulator and the
   output bit-equal; Q1's route at the site (``ops/quant.py:q1_route``), its
   device time beside im2col + ``torch._int_mm`` and the bound, and the
   sites' times summed over one forward beside their summed bound. One
   counted static ``eval_step``: 15 Q1, 16 ``_int_mm``, 1
   K1a; its median ms, img/s and peak memory beside the float fully fused
   ``eval_step`` on the same weights, and its device time by kernel
   (``step_kernel_times``); its logits against the float32 model
   (relative L2 under JAX's 0.15; frame argmax on the frames whose float32
   margin is at least twice the int8 noise). Then ``pool_impl="pallas"``
   (1 K3f, 15 Q1), ``quant_stage1_pad=0`` (8 Q1), ``transcribe_buckets`` at
   ``quant="int8"`` over the 512/1024/2048 buckets (4 K5f a forward at
   1024 and 2048, calibration included) and the int8 conformer's
   ``eval_step`` (15 Q1, 32 ``_int_mm``).
20. deploy serve: the flagship fully fused (seeded weights) exported by
   ``deploy.py:export_serving`` (``torch.export``) at bs 128 and 512, 1024
   and 2048 px, and the calibrated int8 flagship at 512 px, saved as
   bundles under the git-ignored ``build/`` (sizes printed) and reloaded as
   ``ServingBundle`` s. One call of each program on 128 synthetic lines of
   its bucket launches exactly the live ``eval_step``'s kernels less K1a (1
   K3f and 9 K4f, + 4 K5f at 1024 and 2048 px; 15 Q1 at int8) and gives
   ids and lengths bit-equal to the live model's; its time beside the
   live serving function's, the live ``eval_step``'s and
   ``ServingBundle.run``'s (numpy in and out), with the device's busy time
   and span a call under ``torch.profiler``. ``cli/server.py:BatchWorker``
   serves 293 numpy lines from 8 threads in fewer program calls than
   lines, their texts equal to ``ServingBundle.transcribe``'s; a word
   trigram trained by ``decode/lm_train.py`` rescores beam-5 candidates of
   128 lines on the host (``cli/serve.py:beam_lm_texts``), timed, naming
   the native or Python scorer; then ``cli/export.py SYNTH --width-buckets
   512,1024,2048 --verify`` on a seeded checkpoint at the flagship width
   and ``python -m htr_vt_torch.cli.server`` on its bundle as a
   subprocess, polled on ``/healthz`` and stopped.
21. memory levers: the fully fused flagship (bs 128, 512 px, IAM span
   masking, the same seeded state, batch and masks for every row) under
   (remat, grad_accum) = (none, 1), (blocks, 1), (all, 1), (none, 2),
   (none, 4), (all, 4): ms/step (1 warm-up, 3 timed), peak memory, each
   step's launches held to ``lever_launches`` (remat "all" runs K2, K3f and
   K4f twice a pass, grad_accum g every kernel g times), the first pass-1
   loss and grad_norm; the remat rows' metrics of every step and final
   weights bit-equal to the plain row's, or the kernel whose second call
   differs named (``recompute_culprits``) and the phase failed; the plain
   row's ms beside the fully fused train phase's. Then the 2048-px step at
   bs 64 fully fused, plain and under remat "all" (K5f twice a pass), bit
   for bit, and the tri-masked SGM SVTR at bs 128 under grad_accum 4; each
   peak beside the step's peak without a lever (``UNLEVERED_PEAK_MIB``).
22. data parallel: two processes (``--data-parallel-rank``, the
   ``HTRVT_*`` launch) share the card over gloo, bs 64 each, 3 fully fused
   steps in bf16 and in float32, against one process at bs 128 on the same
   weights, batch and masks (losses, grad_norm, weights, EMA, AdamW held at
   ``DP_BARS``; the ranks equal to each other; each rank's launches); then
   ``loop.fit`` (2 steps and an eval) in a world of one over NCCL, and one
   all-reduce of a device tensor on that group.
23. multiwidth: ``cli/train_multiwidth.py:run`` on in-memory lines (no
   cv2) at 512, 1024 and 2048 px, bs 64, the flagship fully fused, one
   TrainState: ``MW_STEPS_PER_WIDTH`` steps a width taken in turn, each
   step's launches held to ``lever_launches`` (no K5 at 512; 2 x depth
   K5f, K5dkv and K5dq at 1024 and 2048), one eval a bucket (launches
   counted) and one checkpoint; ms a step per width and the peak memory.
24. tensor parallel: two processes (``--tensor-parallel-rank``) share the
   card over gloo at ``mesh_shape=(1, 2)``, each holding half of every
   block's heads and MLP units (K5 on 3 heads), the flagship fully fused at
   1024 px and bs 64, 3 steps and one ``validate`` in bf16 and in float32
   (under deterministic algorithms), against one process on the same
   weights, batch and masks at ``TP_BARS``; the ranks' whole states equal;
   each rank's launches and ms a step.
25. tensor parallel over the zoo: two processes
   (``--tensor-parallel-zoo-rank``) share the card over gloo at
   ``mesh_shape=(1, 2)``, at bs 16 against one process on the same
   weights, batch and masks: the tri-masked SGM conformer at 1024 px (the
   fully fused stem's kernels and K5 on a rank's 3 of 6 heads), one SAM
   step in bf16 and one in float32 under deterministic algorithms, then an
   ``eval_step``; window, lgp, squeezeformer, Swin and SVTR at 512 px, an
   ``eval_step`` and a bf16 SAM step; the encoder-decoder's bf16 SAM step
   and its greedy and beam-5 ids (equal to one process's up to a position
   whose float32 margin the bf16 rounding can cross); the int8 vit,
   calibrated, its logits against one process's (bit-equal, or the gap and
   the statistics that differ). Each step at ``TP_BARS``, every rank's
   launches equal to one process's, the ranks' states equal; ms a warm
   second call, rank 0 and one process.
26. width parallel: two processes (``--width-parallel-rank``) share the
   card over gloo at ``mesh_shape=(1, 2)``, each holding half of every
   image's columns (``parallel/mesh.py:shard_width``: the stem's windows
   read their neighbours' edge columns, its BN sums run over the mesh, its
   tokens are gathered before masking), against one process on the same
   weights, batch and masks at bs 64: the fully fused flagship at 512 px,
   three SAM steps in bf16 and three in float32 under deterministic
   algorithms, the stock and fused stems' three bf16 steps, an
   ``eval_step``, and one fully fused bf16 step at 2048 px (K5 after the
   gather) and one under remat "all" (the stem's recompute replays its
   exchanges and all-reduces inside the backward), each followed by a
   warm, timed step; van, van2, Swin and SVTR at 512 px and bs 16, an
   ``eval_step`` and one SAM step; the int8 flagship, calibrated on a
   batch of strips, then a static ``eval_step`` (stage 1 padded, and with
   ``pool_impl="pallas"``), its logits against one process's (bit-equal,
   or within the int8-against-float32 gap). Each at ``TP_BARS``, every
   rank's launches a step those of ``per_step_launches`` /
   ``lever_launches``, the ranks' states equal; warm ms a step (the median
   after the first step, the first beside it) and peak memory a rank
   against one process's (at 2048 px a rank's must be lower); K3f, K4f and
   Q1 (a W-stride-1 site with its BN prologue, and a W-stride-2 site on the
   s8 carry's left-column form) on a rank's halo-extended strip against
   their plain versions.

Phases 22, 24 and 26 read ms a step as the median of the steps after the
first, the first step's beside it; their comparisons are taken from the
seeded state, first step included.

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

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from htr_vt_torch import (CTCLabelConverter, ExperimentConfig,  # noqa: E402
                          MaskConfig, ModelConfig, OptimConfig, _build)
from htr_vt_torch.cli import export as cli_export  # noqa: E402
from htr_vt_torch.cli.args import args_to_config, build_parser  # noqa: E402
from htr_vt_torch.cli.serve import (beam_lm_texts, load_serving_model,  # noqa: E402
                                    transcribe, transcribe_buckets)
from htr_vt_torch.cli.server import BatchWorker  # noqa: E402
from htr_vt_torch.data.loader import (build_dataset, choose_max_label_len,  # noqa: E402
                                      make_converter)
from htr_vt_torch.config import (AugmentConfig, DataConfig, ParallelConfig,  # noqa: E402
                                 SGMConfig, TrainConfig, config_to_dict)
from htr_vt_torch.decode.lm import NgramScorer  # noqa: E402
from htr_vt_torch.decode.lm_train import train_ngram_arpa  # noqa: E402
from htr_vt_torch.deploy import (ServingBundle, export_serving,  # noqa: E402
                                 make_serving_fn, save_bundle)
from htr_vt_torch.native.build import load_native  # noqa: E402
from htr_vt_torch.eval.validate import validate  # noqa: E402
from htr_vt_torch.models.encoder_decoder import generate  # noqa: E402
from htr_vt_torch.models.htr_vt import build_model  # noqa: E402
from htr_vt_torch.models.sgm import SGMVocab, make_context_arrays  # noqa: E402
from htr_vt_torch.models.variants import apply_variant_preset  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from htr_vt_torch.ops import (conv_fused, ctc_cuda, flash_attn,  # noqa: E402
                              pool_fused)
from htr_vt_torch.ops import quant as q8  # noqa: E402
from htr_vt_torch.ops.bn_stats import bn_stats, bn_stats_reference  # noqa: E402
from htr_vt_torch.ops.ctc import NEG, ctc_loss, ctc_loss_auto  # noqa: E402
from htr_vt_torch.train import loop  # noqa: E402
from htr_vt_torch.train.checkpoint import CheckpointManager  # noqa: E402
from htr_vt_torch.train.state import create_train_state  # noqa: E402
from htr_vt_torch.text.ed_tokenizer import EDTokenizer  # noqa: E402
from htr_vt_torch.train.step import eval_step, eval_step_ed, train_step  # noqa: E402

SEED = 0
BATCH = 128
N_IMAGES = 3 * BATCH + 37  # four requests; the last one padded to 128
LMAX = 96  # labelled eval shape: S = 2*96+1 = 193
SERVE_LMAX = 8  # serve.py's dummy labels: S = 17
# Alpha/beta kernel vs plain: float32, the same expf/logf recursion; only
# the gather and the order of the three-way logaddexp terms may round apart.
ALPHA_RTOL, ALPHA_ATOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
# d logits through the kernels against the same backward glue over the
# plain recursions: alpha and beta within their bars above, the glue (its
# class sum in a fixed order) the same code on both sides.
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
            "flash_attention_bwd_dq": flash_attn.flash_attention_bwd_dq,
            "conv_int8": q8.conv_int8_cuda, "int_mm": q8.int_mm}
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
                ("small_d512", (2, 3, 256, 512), True, (torch.float32,)),
                # a rank's 3 of the 6 heads under a model axis of 2 (phase 24),
                # the multi-width recipe's training shapes
                ("tp1024_h3", (64, 3, 256, 128), True, BOTH),
                ("tp2048_h3", (64, 3, 512, 128), True, BOTH),
                # and the tri-masked SGM conformer's at bs 16 (phase 25,
                # TPZ_K5_SHAPE)
                ("tpz1024_h3", (16, 3, 256, 128), True, BOTH))
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
# The CTC gradient's glue sums each class's states in a fixed order
# (ops/ctc_cuda.py:class_sum), so two default-mode runs of the same steps
# give equal bits, and the resume is held bit for bit. Under
# torch.use_deterministic_algorithms (with the cuBLAS workspace setting it
# asks for) the pair is held bit for bit too, and against the default-mode
# run, whose cuDNN algorithms are other ones, at the bars below.
CUBLAS_DETERMINISTIC = ":4096:8"
# The default-mode run against the deterministic one, at about 4x the
# largest reading on the H100 (PERF.md section 6): each pass-1 loss's
# relative gap (read up to 5.95e-4); for the model, the EMA model and the
# AdamW moments the L2 norm of the gap over the L2 norm of the state (read
# up to 6.0e-4, 5.2e-4 and 0.24: six warm-up steps carry a few ulps into the
# moments that far); and each leaf's largest |gap| over its largest |value|
# (read up to 1.9: a leaf whose exact gradient is zero, such as the
# attention's key bias, gets rounding noise that AdamW scales to full-size
# steps). These catch a gross fault only.
FIT_LOSS_REL, FIT_LEAF_SHARE = 2e-3, 4.0
FIT_STATE_L2 = {"model": 2.5e-3, "ema_model": 2.5e-3, "adamw": 1.0}
# The block recipes of htr_vt_torch/models/variants.py at the flagship width
# (each with its preset depth), served fully fused against the stock ops;
# the two whose global blocks take K5 at 2048 px (N = 512) with their count
# of K5f launches per eval_step (conformer: 4 blocks; localglobal: blocks 2
# and 3).
ZOO_RECIPES = ("window", "macaron", "macaron_2", "localglobal", "lgp", "lgp_svtr",
               "conformer", "squeezeformer")
ZOO_WIDE = {"conformer": 4, "localglobal": 2}
STOCK_OPS = dict(attn_impl="xla", conv_impl="auto", pool_impl="auto", bn_stats_impl="auto")
# The tri-masked MMS trainer (model_sgm_mms_conv: conformer, SGM on): the
# forwards a SAM pass runs, its steps at bs 128 (warm-up, timed) and at
# 64x1024 px (bs 64, N = 256, where K5 runs in training: 4 blocks a forward).
TRI_FORWARDS = 3
SGM_WARMUP, SGM_STEPS, SGM_WIDE_STEPS = 1, 3, 2
SGM_SUB_LEN = 5
# The zoo's standalone models and VAN stems (model_sgm_mms_swin, _svtr,
# _attach_van, _attach_van_2): Swin at its constructor's widths, SVTR tiny,
# van and van2 behind the flagship trunk. Built with the fully fused
# switches, which reach none of their stems: only K1 may launch. Swin and
# SVTR also serve at 1024 px (bs 64, the per-grid tables); each trains
# tri-masked with the SGM head and MMS masking, SAM + AdamW at bs 128.
ZOO_STANDALONE = ("swin", "svtr", "van", "van2")
ZOO_STANDALONE_WIDE = ("swin", "svtr")
ZOO_SAM_WARMUP, ZOO_SAM_STEPS = 1, 3
OWN_OPS = "a second call of itself (no stem or attention kernel to swap out)"
# The encoder-decoder (run/train_encoder_decoder_iam.sh) at full width, its
# trunk fully fused: fit for ED_STEPS steps with an EMA eval_step_ed and a
# checkpoint every ED_EVAL, and the same run stopped at ED_EVAL and resumed;
# ED_LINES train and val lines with texts of 1-96 characters (ed_len 98).
ED_RECIPE = ["IAM", "--model-type", "encoder_decoder", "--decoder-layers", "6",
             "--decoder-heads", "8", "--max-seq-len", "256", "--label-smoothing", "0.1",
             "--max-lr", "1e-3", "--train-bs", str(BATCH), "--weight-decay", "0.5",
             "--img-size", "512", "64"]
ED_LINES = (512, BATCH)
ED_STEPS, ED_EVAL = 4, 2
ED_BEAM = 5
# int8 serving: calibration batches (cli/test.py --calib-batches), JAX's
# relative-L2 bar for int8 logits against float (tests/test_quant.py), and
# Q1's sites in one forward of the flagship at bs 128 with stage 1 padded to
# 256: (name, NCHW input, Cout, kernel, stride, padding, input kind, output
# dtype, launches a forward). "s8" is the carry, "bf16+bn" a bf16 input
# normalised and quantized by Q1, "bf16" one quantized by it. The last two
# are the pool_impl="pallas" stem's stage-1 entry (its pool hands bf16).
INT8_CALIB_BATCHES = 4
INT8_LOGITS_REL = 0.15
INT8_SITES = (
    ("s1_entry_conv1", (BATCH, 192, 16, 512), 256, 3, (2, 1), 1, "s8", torch.bfloat16, 1),
    ("s1_entry_proj", (BATCH, 192, 16, 512), 256, 1, (2, 1), 0, "s8", torch.bfloat16, 1),
    ("s1_conv2", (BATCH, 256, 8, 512), 256, 3, (1, 1), 1, "bf16+bn", torch.bfloat16, 2),
    ("s1_conv1", (BATCH, 256, 8, 512), 256, 3, (1, 1), 1, "s8", torch.bfloat16, 1),
    ("s2_entry_conv1", (BATCH, 256, 8, 512), 384, 3, (2, 2), 1, "s8", torch.bfloat16, 1),
    ("s2_entry_proj", (BATCH, 256, 8, 512), 384, 1, (2, 2), 0, "s8", torch.bfloat16, 1),
    ("s2_conv2", (BATCH, 384, 4, 256), 384, 3, (1, 1), 1, "bf16+bn", torch.bfloat16, 2),
    ("s2_conv1", (BATCH, 384, 4, 256), 384, 3, (1, 1), 1, "s8", torch.bfloat16, 1),
    ("s3_entry_conv1", (BATCH, 384, 4, 256), 768, 3, (2, 2), 1, "s8", torch.bfloat16, 1),
    ("s3_entry_proj", (BATCH, 384, 4, 256), 768, 1, (2, 2), 0, "s8", torch.bfloat16, 1),
    ("s3_conv2", (BATCH, 768, 2, 128), 768, 3, (1, 1), 1, "bf16+bn", torch.bfloat16, 2),
    ("s3_conv1", (BATCH, 768, 2, 128), 768, 3, (1, 1), 1, "s8", torch.bfloat16, 1),
    ("pallas_pool_conv1", (BATCH, 192, 16, 512), 256, 3, (2, 1), 1, "bf16",
     torch.bfloat16, 0),
    ("pallas_pool_proj", (BATCH, 192, 16, 512), 256, 1, (2, 1), 0, "bf16",
     torch.float32, 0),
)
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak (H100 SXM data sheet)
# The cached decode against the uncached one on the same weights: float32
# (TF32 off) sums over a longer, masked key axis, argmax equal everywhere;
# in bf16 the attention outputs round to bf16 after sums in another order,
# so the argmax is held on ED_DECODE_AGREEMENT of the positions.
ED_DECODE_F32_ATOL, ED_DECODE_AGREEMENT = 1e-3, 0.99
# deploy and serve: the flagship fully fused exported at the serving buckets
# (bs 128) and at int8 at 512 px; the server's worker fed from DEPLOY_THREADS
# threads with DEPLOY_LINES lines at 512 px and a collection window of
# DEPLOY_WAIT_MS; beam search of DEPLOY_BEAM with a word trigram LM trained
# by decode/lm_train.py on DEPLOY_LM_LINES synthetic texts, at weight 0.5.
DEPLOY_WIDTHS = SERVE_WIDTHS
DEPLOY_THREADS, DEPLOY_LINES, DEPLOY_WAIT_MS = 8, 2 * BATCH + 37, 50.0
DEPLOY_BEAM, DEPLOY_LM_LINES, DEPLOY_LM_WEIGHT = 5, 2000, 0.5
# cli/export.py as a user runs it: the SYNTH preset (its alphabet needs no
# line images) at the flagship width, the stem switches at their defaults.
DEPLOY_CLI = ["SYNTH"]
# The memory levers on the fully fused flagship at bs 128 and 512 px: the
# (remat, grad_accum) rows, each from the same seeded state, batch and masks,
# one warm-up and LEVER_STEPS timed steps; the 2048-px step at bs 64
# (WIDE_BATCH) plain and under remat "all"; the tri-masked SGM SVTR at bs
# 128 under grad_accum SVTR_ACCUM. UNLEVERED_PEAK_MIB: the peaks of the
# same steps before the levers existed (this script's fully fused train,
# wide train and zoo standalone phases on an NVIDIA H100 80GB HBM3 at
# 700.00 W; the 2048-px step with the stock stem), printed beside the rows.
LEVER_ROWS = (("none", 1), ("blocks", 1), ("all", 1), ("none", 2), ("none", 4),
              ("all", 4))
WIDE_LEVER_ROWS = (("none", 1), ("all", 1))
LEVER_WARMUP, LEVER_STEPS = 1, 3
SVTR_ACCUM = 4
UNLEVERED_PEAK_MIB = {"flagship": 10600.4, "wide2048": 32986.7, "svtr": 52316.5}
# Data parallel on the one card: DP_RANKS processes over gloo at BATCH //
# DP_RANKS rows each, DP_STEPS fully fused steps, against one process at
# BATCH on the same weights, batch and masks (the ranks draw the global
# masks, parallel/mesh.py:rank_rows), in bf16 in default mode (the
# production step) and in float32 under torch.use_deterministic_algorithms
# (two default-mode float32 runs of one process need not give equal bits on
# the card). The ranks add the BN sums and the gradient in another order than
# one process. In bf16 that moves activations across bf16 rounding
# boundaries and the stem's gradient with them; from the second step AdamW
# turns gradients under that noise into steps of either sign. DP_BARS
# (relative gaps of the first step's losses and gradient norm, of every
# step's, and each part's L2 gap of the state): bf16, the losses at the
# fit phase's FIT_LOSS_REL, the gradient norm at 2e-2 (read 8.2e-4 at the
# first step and 7.3e-3 at the third on an H100 80GB HBM3 at 700 W; at the
# CPU tests' tiny bf16 config 1.3e-3 to 1.1e-2), the state at FIT_STATE_L2;
# float32, which holds the collectives themselves, the first step's losses
# at 1e-5 (read 6.9e-7) and gradient norm at 1e-4 (read 1.5e-5 in default
# and deterministic mode alike: the flagship's float32 sums over 2M
# elements a channel, split by rank; CPU tiny config 1.4e-7), every step at
# 1e-4 (losses) and 2e-3 (gradient norm; read up to 5.2e-4 at the third
# step) and the weights' L2 at 2.5e-4 (a tenth of bf16's; read 4.1e-5). A
# fault of the collectives (BN statistics of one rank's rows, a gradient
# summed and not averaged) moves these by 1e-2 and more. DP_TIMEOUT bounds a
# worker.
DP_RANKS, DP_STEPS, DP_TIMEOUT = 2, 3, 600
DP_DTYPES = ("bfloat16", "float32")
DP_DETERMINISTIC = ("float32",)
DP_BARS = {"bfloat16": dict(first_loss=FIT_LOSS_REL, first_grad_norm=2e-2,
                            loss=FIT_LOSS_REL, grad_norm=2e-2, state=FIT_STATE_L2),
           "float32": dict(first_loss=1e-5, first_grad_norm=1e-4, loss=1e-4,
                           grad_norm=2e-3,
                           state={"model": 2.5e-4, "ema_model": 2.5e-4, "adamw": 1.0})}
DP_FIT_STEPS = 2
# The multi-width recipe (phase 23): its buckets, steps a width (the first of
# each width warms up), lines a bucket and the eval that follows.
MW_WIDTHS = (512, 1024, 2048)
MW_STEPS_PER_WIDTH = 3
MW_TRAIN_LINES, MW_EVAL_LINES = 2 * WIDE_BATCH, WIDE_BATCH
# Tensor parallel on the one card (phase 24): TP_RANKS processes at
# mesh_shape (1, TP_RANKS), each holding half of every block's heads and MLP
# units, at 1024 px and bs 64, TP_STEPS fully fused steps and one validate,
# against one process on the same weights, batch and masks; bf16 in default
# mode, float32 under torch.use_deterministic_algorithms. Bars, written
# before the first run on the card: the model axis adds each row-sharded
# product's two float32 partials and rounds once (layers.py:partial_dense),
# so a bf16 forward is one rounding from one process's, and the sums it
# reorders are fewer than data parallelism's (only the blocks' products, not
# the stem's BN sums): DP_BARS, whose readings these should undercut. The
# validate after the third step: its loss at every step's loss bar, its CER
# within 0.05 of one process's (the weights are random, so many frames'
# argmax sits near a tie that the step's noise can flip; a CPU rehearsal at
# embed 64 in bf16 read 0.029).
TP_RANKS, TP_STEPS, TP_TIMEOUT, TP_WIDTH = 2, 3, 600, 1024
TP_BARS = DP_BARS
TP_CER_GAP = 0.05
# Tensor parallel over the zoo (phase 25): TP_RANKS processes at mesh_shape
# (1, TP_RANKS) on the one card over gloo, each model at the flagship width
# (its preset) against one process on the same weights, batch and masks, at
# bs TPZ_BATCH: the tri-masked SGM conformer at TPZ_SGM_WIDTH px (N = 256:
# K5 on a rank's 3 of 6 heads, TPZ_K5_SHAPE) for one SAM step in bf16 and
# one in float32 under deterministic algorithms, then an eval_step; the
# TPZ_ZOO models at 512 px for an eval_step and one bf16 SAM step; the
# encoder-decoder (6 decoder layers of 8 heads) for one bf16 SAM step and
# greedy and beam-ED_BEAM generation of TPZ_ED_LEN positions; the int8 vit
# at 512 px calibrated on one batch, then an eval_step. Each at TP_BARS; the
# eval losses at the losses' bar; the generated ids equal to one process's
# up to the first position whose float32 top-2 margin is under twice the
# bf16 model's largest logit error (where bf16 rounding can flip the
# argmax), the zoo phases' argmax floor.
TPZ_BATCH, TPZ_SGM_WIDTH, TPZ_WIDTH = 16, 1024, 512
TPZ_ZOO = ("window", "lgp", "squeezeformer", "swin", "svtr")
TPZ_ED_LEN, TPZ_ED_LMAX = 24, 22
TPZ_K5_SHAPE = (TPZ_BATCH, 3, 256, 128)


# Width sharding on the one card (phase 26): WP_RANKS processes at mesh_shape
# (1, WP_RANKS) over gloo, each holding W / WP_RANKS of the image's columns
# (``parallel/mesh.py:shard_width`` / ``rank_width``; the encoder replicated,
# the layout of tests/test_parallel.py:180-199), against one process on the
# same weights, batch and masks: the flagship at WP_WIDTH px, bs WIDE_BATCH,
# WP_STEPS SAM steps for each of WP_RUNS (the fully fused stem in bf16 and in
# float32 under deterministic algorithms, the stock and fused stems in bf16),
# the first run's eval_step before its steps, and one fully fused bf16 step
# at WP_WIDE px (K5 after the tokens' gather), each rank's peak memory
# against one process's. Bars, written before the first run on the card: the
# stem's BN sums and its gradients are split and added as data parallelism
# splits them (phase 22), so TP_BARS; the eval loss at the loss bar and the
# frame argmax agreeing on at least MIN_ARGMAX_AGREEMENT of the frames.
WP_RANKS, WP_STEPS, WP_TIMEOUT, WP_WIDTH, WP_WIDE = 2, 3, 900, 512, 2048
WP_SWITCHES = {"stock": {}, "fused": FUSED, "fully_fused": FULLY_FUSED}
WP_RUNS = (("fully_fused", "bfloat16"), ("fully_fused", "float32"),
           ("stock", "bfloat16"), ("fused", "bfloat16"))
# Every run's ms a step is the median of its steps after the first (steps 2-3
# of WP_RUNS; the WP_WIDE rows take a second, warm step after the compared
# one), beside the first step's, which the gaps are read from. The rest of
# the models under width sharding: the fully fused bf16 step at WP_WIDE px
# under remat "all" (its peak a rank against one process's remat-all peak
# and against WP_WIDE_RANK_PEAK_MIB, a width-sharded rank's peak over one
# step without remat, as this phase first read it on an NVIDIA H100 80GB
# HBM3 at 700.00 W); WP_ZOO at WP_WIDTH px, bs
# TPZ_BATCH (an eval_step and one compared SAM step, then a warm one of
# each, as phase 25); the int8 flagship (WP_INT8_FORMS) at WP_WIDTH px, bs
# TPZ_BATCH, calibrated on one batch of strips, then a static eval_step,
# its logits bit-equal to one process's or, past that, within the int8
# against float32 gap with the argmax equal on the frames whose top-2
# margin clears twice the largest logit gap (phase 25's int8 reading; the
# input LayerNorm's split sums can move an image value across a bf16
# rounding edge, and an int8 code with it).
WP_ZOO = ("van", "van2", "swin", "svtr")
WP_INT8_FORMS = {"int8": {}, "int8_pallas_pool": dict(pool_impl="pallas")}
WP_WIDE_RANK_PEAK_MIB = 13806.9


def per_step_launches(switches, forwards=1):
    """Launches of each kernel per SAM train step with the stem switches;
    ``forwards`` masked forwards a pass (3 for the tri-masked trainer)."""
    want = {"ctc_alpha": 2, "ctc_beta": 2}
    if switches.get("bn_stats_impl") == "pallas":
        want["bn_stats"] = 32  # every BN of the stem, both passes
    if switches.get("pool_impl") == "pallas":
        want.update(pool_bn_relu_fwd=2, pool_bn_relu_bwd=2)
    if switches.get("conv_impl") == "pallas":  # 9 stride-1 convs a forward
        want.update(conv3x3_bn_relu_fwd=18, conv3x3_bn_relu_dgrad=18,
                    conv3x3_bn_relu_wgrad=18)
    return {k: n * forwards for k, n in want.items()}


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


STEP_PROFILE_CALLS = 5


def step_kernel_times(fn, calls=STEP_PROFILE_CALLS):
    """The device's kernels of ``calls`` back-to-back calls of a step under
    ``torch.profiler``, after a warm call: by kernel name (launches, device
    ms) a call, their sum (busy_ms), the kernels a call and the span a call
    from the first kernel's start to the last one's end."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = {}
    for e in events:
        n, ms = kernels.get(e.name, (0, 0.0))
        kernels[e.name] = (n + 1 / calls,
                           ms + (e.time_range.end - e.time_range.start) * 1e-3 / calls)
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) * 1e-3 / calls
    return dict(kernels=kernels, kernels_a_call=len(events) / calls, span_ms=span,
                busy_ms=sum(ms for _, ms in kernels.values()))


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
def zoo_batch(n, width, rng, device):
    """n line images at ``width`` px with labels of length 1-96."""
    labels = rng.integers(1, ModelConfig().nb_cls, (n, LMAX)).astype(np.int32)
    lengths = rng.integers(1, LMAX + 1, n).astype(np.int32)
    labels[np.arange(LMAX)[None] >= lengths[:, None]] = 0
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {"image": put(line_images(n, rng, width)), "labels": put(labels),
            "label_lengths": put(lengths)}


def _zoo_case(name, model, stock, ref32, batch, want, tag,
              stock_name="the stock ops (attn_impl=xla, stock stem)"):
    """One recipe at one width: the fully fused model's counted eval_step
    against the stock-ops model on the same weights, then its eval_step
    time. Random weights leave many frames with a top-2 margin under the
    stock ops' own bf16 rounding (their frame argmax against float32 read
    96.5-99.97% over the recipes, PERF.md section 6), so the fully fused
    serve phase's floor, MIN_ARGMAX_AGREEMENT of the frames, is held
    against the float32 argmax on the frames whose float32 margin is at
    least twice the stock bf16 model's largest logit error: there the
    stock ops cannot flip it, and a flip means a larger error than theirs."""
    reset_counts()
    out = eval_step(model, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != {**dict.fromkeys(COUNTERS, 0), **want}:
        raise AssertionError(f"[{tag}] {name}: eval_step launched {counts}; expected "
                             f"{want}")
    logits = out["logits"]
    with torch.inference_mode():
        rl, r32 = stock(batch["image"]), ref32(batch["image"])
    if logits.shape != rl.shape or not torch.isfinite(logits).all() or \
            not torch.isfinite(out["loss_per_sample"]).all():
        raise AssertionError(f"[{tag}] {name}: logits {tuple(logits.shape)} / "
                             f"{tuple(rl.shape)}, finite {bool(torch.isfinite(logits).all())}")
    dmax = (logits - rl).abs().max().item()
    agree = (logits.argmax(-1) == rl.argmax(-1)).float().mean().item()
    stock_err = (rl - r32).abs().max().item()
    top2 = r32.topk(2, dim=-1).values
    decidable = (top2[..., 0] - top2[..., 1]) >= 2 * stock_err
    want_ids = r32.argmax(-1)[decidable]
    held = (logits.argmax(-1)[decidable] == want_ids).float().mean().item()
    stock_held = (rl.argmax(-1)[decidable] == want_ids).float().mean().item()
    stock_f32 = (rl.argmax(-1) == r32.argmax(-1)).float().mean().item()
    ms = median_ms(lambda: eval_step(model, batch), 10)
    rows = batch["image"].shape[0]
    rec = dict(eval_ms=ms, img_s=rows / ms * 1e3, rows=rows, max_dlogits=dmax,
               argmax_agreement=agree, stock_vs_f32_agreement=stock_f32,
               decidable_share=decidable.float().mean().item(),
               decidable_agreement=held, launches=counts,
               loss=out["loss"].item(), frames=logits.shape[1])
    say(f"[{tag}] {name}: eval_step {ms:.3f} ms ({rec['img_s']:.1f} img/s, bs {rows}) at "
        f"{batch['image'].shape[2]} px, {logits.shape[1]} frames; vs {stock_name} "
        f"on the same weights: max |dlogits| {dmax:.4f}, "
        f"frame argmax agreement {agree:.4%} (the stock ops' bf16 vs their float32: "
        f"{stock_f32:.4%}, largest logit error {stock_err:.4f}); on the "
        f"{rec['decidable_share']:.2%} of frames whose float32 margin is at least "
        f"{2 * stock_err:.4f}: fully fused {held:.4%}, stock {stock_held:.4%} of the "
        f"float32 argmax (floor {MIN_ARGMAX_AGREEMENT:.0%}); launches {counts}")
    if held < MIN_ARGMAX_AGREEMENT or not decidable.any():
        raise AssertionError(f"[{tag}] {name}: argmax agreement {held:.4%} on the "
                             f"decidable frames, below {MIN_ARGMAX_AGREEMENT:.0%}")
    return counts, rec


def phase_zoo_serve(device, smi_line):
    """Every block recipe at the flagship width with its preset depth, fully
    fused, seeded weights: eval_step at bs 128 and 512 px against the same
    weights on the stock ops; conformer and localglobal again at 2048 px,
    where their global blocks take K5f."""
    rng = np.random.default_rng(SEED + 40)
    batch = zoo_batch(BATCH, 512, rng, device)
    wide = zoo_batch(BATCH, 2048, rng, device)
    launches = dict.fromkeys(COUNTERS, 0)
    rec = {}
    for i, name in enumerate(ZOO_RECIPES):
        cfg = apply_variant_preset(ModelConfig(encoder=name, **FULLY_FUSED))
        model = build_model(cfg, device=device,
                            generator=torch.Generator(device=device).manual_seed(SEED + i))
        stock = build_model(dataclasses.replace(cfg, **STOCK_OPS), device=device)
        stock.load_state_dict(model.state_dict(), strict=True)
        ref32 = build_model(dataclasses.replace(cfg, compute_dtype="float32", **STOCK_OPS),
                            device=device)
        ref32.load_state_dict(model.state_dict(), strict=True)
        n_params = sum(p.numel() for p in model.parameters())
        say(f"[zoo serve] {name}: embed {cfg.embed_dim}, heads {cfg.num_heads}, depth "
            f"{cfg.depth}, blocks {model.block_names}, {n_params} parameters, "
            f"{cfg.compute_dtype}, fully fused stem")
        counts, rec[name] = _zoo_case(name, model, stock, ref32, batch,
                                      per_eval_launches(FULLY_FUSED), "zoo serve")
        if name in ZOO_WIDE:
            want = {**per_eval_launches(FULLY_FUSED),
                    "flash_attention_fwd": ZOO_WIDE[name]}
            wide_counts, rec[f"{name}_2048"] = _zoo_case(name, model, stock, ref32, wide,
                                                         want, "zoo serve 2048")
            counts = {k: counts[k] + wide_counts[k] for k in counts}
        launches = {k: launches[k] + counts[k] for k in launches}
        del model, stock, ref32
    torch.cuda.empty_cache()
    say(f"[zoo serve] {len(ZOO_RECIPES)} recipes, launches {launches}; {smi_line}")
    return launches, rec


def sgm_batch(n, width, lmax, vocab, rng, device):
    """``zoo_batch``-like lines whose texts (of length 1 to ``lmax``) give
    the CTC labels and the SGM context windows."""
    alphabet = vocab.itos[1:ModelConfig().nb_cls]
    lengths = rng.integers(1, lmax + 1, n)
    texts = ["".join(alphabet[j] for j in rng.integers(0, len(alphabet), m))
             for m in lengths]
    labels = np.zeros((n, lmax), np.int32)
    for i, t in enumerate(texts):
        labels[i, :len(t)] = [vocab.stoi[c] for c in t]
    arrays = make_context_arrays(texts, vocab, lmax, SGM_SUB_LEN)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {"image": put(line_images(n, rng, width)), "labels": put(labels),
            "label_lengths": put(lengths.astype(np.int32)),
            **{k: put(v) for k, v in arrays.items()}}


def _sgm_steps(state, batch, n, per_step, tag):
    """``n`` counted tri-masked SAM steps: each launch count held per step,
    the step's CUDA-event time, its metrics finite."""
    times, metrics = [], []
    for _ in range(n):
        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = train_step(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        after = read_counts()
        step = {k: after[k] - before[k] for k in after}
        if step != {**dict.fromkeys(COUNTERS, 0), **per_step}:
            raise AssertionError(f"[{tag}] a tri-masked step launched {step}; expected "
                                 f"{per_step}")
        metrics.append({k: v.item() for k, v in m.items()})
        if not all(math.isfinite(v) for v in metrics[-1].values()) or \
                {"loss_sgm", "loss_ctc"} - set(metrics[-1]):
            raise AssertionError(f"[{tag}] metrics {metrics[-1]}")
    return times, metrics


def phase_sgm_mms_train(device, smi_line):
    """model_sgm_mms_conv at the flagship width, fully fused: the conformer
    recipe with the SGM head and the tri-masked trainer, SAM + AdamW at bs
    128 (three masked forwards a pass, six per step), then at 64x1024 px
    (bs 64, N = 256), where its 4 blocks' attention takes K5 in training."""
    vocab = SGMVocab(CTCLabelConverter([chr(c) for c in range(33, 33 + 79)]))
    model_cfg = apply_variant_preset(ModelConfig(
        encoder="conformer", masking=MaskConfig(mode="mms", max_span_length=8),
        sgm=SGMConfig(enable=True, vocab_size=vocab.size, sub_len=SGM_SUB_LEN),
        **FULLY_FUSED))
    cfg = ExperimentConfig(model=model_cfg, optim=OptimConfig(),
                           train=TrainConfig(tri_masked=True))
    state = create_train_state(cfg, device,
                               torch.Generator(device=device).manual_seed(SEED + 50))
    rng = np.random.default_rng(SEED + 51)
    batch = sgm_batch(BATCH, 512, LMAX, vocab, rng, device)
    per_step = per_step_launches(FULLY_FUSED, TRI_FORWARDS)
    n_params = sum(p.numel() for p in state.model.parameters())
    say(f"[sgm mms train] conformer, embed {model_cfg.embed_dim}, depth "
        f"{model_cfg.depth}, heads {model_cfg.num_heads}, SGM head (vocab {vocab.size}, "
        f"sub_len {SGM_SUB_LEN}, ctc_lambda {model_cfg.sgm.ctc_lambda}, sgm_lambda "
        f"{model_cfg.sgm.sgm_lambda}), tri-masked ({TRI_FORWARDS} forwards a pass), "
        f"fully fused stem, SAM + AdamW, bs {BATCH}, labels of 1-{LMAX}; "
        f"{n_params} parameters")

    # --- the main path, counted ------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, metrics = _sgm_steps(state, batch, SGM_WARMUP + SGM_STEPS, per_step,
                                "sgm mms train")
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times[SGM_WARMUP:])
    rec = {512: dict(ms=ms, img_s=BATCH / ms * 1e3, first_ms=times[0],
                     peak_mib=peak / 2**20, metrics=metrics)}
    say(f"[sgm mms train] {SGM_STEPS} steps after {SGM_WARMUP} warm-up: median "
        f"{ms:.3f} ms/step ({BATCH / ms * 1e3:.1f} img/s; first {times[0]:.3f}), "
        f"peak memory {peak / 2**20:.1f} MiB; launches per step {per_step}; loss "
        + " ".join(f"{m['loss']:.4f}" for m in metrics) + "; loss_sgm "
        + " ".join(f"{m['loss_sgm']:.4f}" for m in metrics) + "; loss_ctc "
        + " ".join(f"{m['loss_ctc']:.4f}" for m in metrics) + "; grad_norm "
        + " ".join(f"{m['grad_norm']:.4f}" for m in metrics) + f"; {smi_line}")

    # --- at 64x1024 px: K5 in the conformer's attention -------------------
    wide = sgm_batch(WIDE_BATCH, 1024, WIDE_LMAX[1024], vocab, rng, device)
    k5 = model_cfg.depth * TRI_FORWARDS * 2
    per_wide = {**per_step, "flash_attention_fwd": k5, "flash_attention_bwd_dkv": k5,
                "flash_attention_bwd_dq": k5}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wtimes, wmetrics = _sgm_steps(state, wide, SGM_WIDE_STEPS, per_wide,
                                  "sgm mms train 1024")
    wpeak = torch.cuda.max_memory_allocated()
    rec[1024] = dict(ms=wtimes[-1], img_s=WIDE_BATCH / wtimes[-1] * 1e3,
                     first_ms=wtimes[0], peak_mib=wpeak / 2**20, metrics=wmetrics)
    launches = read_counts()
    say(f"[sgm mms train 1024] bs {WIDE_BATCH}, N 256: {SGM_WIDE_STEPS} steps, the "
        f"second {wtimes[-1]:.3f} ms ({rec[1024]['img_s']:.1f} img/s; first "
        f"{wtimes[0]:.3f}), peak memory {wpeak / 2**20:.1f} MiB; launches per step "
        f"{per_wide}; loss " + " ".join(f"{m['loss']:.4f}" for m in wmetrics)
        + "; loss_sgm " + " ".join(f"{m['loss_sgm']:.4f}" for m in wmetrics))
    del state
    torch.cuda.empty_cache()
    return launches, rec


class LineSet:
    """Seeded in-memory lines for ``fit`` on a machine that cannot render or
    read line images (no cv2, no PIL): uint8 [64, width] "handwriting"
    (``line_images``) with random texts of ``lengths`` (1-96 by default)
    characters of ``alphabet``, as ``train_batch`` labels them."""

    def __init__(self, n, alphabet, seed, width=512, lengths=(1, LMAX)):
        rng = np.random.default_rng(seed)
        self.images = np.uint8(np.clip(line_images(n, rng, width)[..., 0] * 255.0, 0, 255))
        self.alphabet = sorted(alphabet)
        self.labels = ["".join(alphabet[i] for i in rng.integers(0, len(alphabet), m))
                       for m in rng.integers(lengths[0], lengths[1] + 1, n)]

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


def _recorded_fit(cfg, datasets, device, times=None):
    """``loop.fit`` with each step's pass-1 loss kept (device scalars, read
    after the run); with ``times``, each step's CUDA events appended."""
    losses = []

    def recording(state, batch):
        if times is not None:
            times.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            times[-1][0].record()
        metrics = train_step(state, batch)
        if times is not None:
            times[-1][1].record()
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


def compare_states(got, want, got_losses, want_losses, noise_leaves=frozenset()):
    """Two runs' final state files and pass-1 losses: bit_equal; the largest
    relative loss gap; for the model, the EMA model and the AdamW moments the
    largest |gap|, the L2 norm of the gap over the state's (``*_l2``), and
    the largest |gap| of a leaf over the leaf's largest |value| (``*_leaf``,
    with the leaf that has it), leaving out of that share the leaves named in
    ``noise_leaves`` (``zero_gradient_leaves``: values that are rounding
    noise on both sides)."""
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
        if name not in noise_leaves and share >= out.get(f"{part}_leaf", (-1.0,))[0]:
            out[f"{part}_leaf"] = (share, name)
        d2, b2 = sums.get(part, (0.0, 0.0))
        sums[part] = (d2 + (a - b).square().sum().item(), b2 + b.square().sum().item())
    for part, (d2, b2) in sums.items():
        out[f"{part}_l2"] = math.sqrt(d2 / b2) if b2 else (0.0 if d2 == 0 else math.inf)
    out["bit_equal"] = (got_losses == want_losses and got["step"] == want["step"]
                        and out["generator_equal"]
                        and out["model"] == out["ema_model"] == out["adamw"] == 0.0)
    return out


def zero_gradient_leaves(model):
    """The state leaves of ``model`` whose gradient is exactly zero, by
    state_dict name and by AdamW's moments of their index: the bias of a
    conv that feeds a train-mode BatchNorm (a VAN block's ``proj2``, SVTR's
    embeds; ``tests/test_torch_port_zoo_sam.py:ZERO_GRADIENT``). Two runs
    give them rounding noise, whose gap against its own largest value says
    nothing."""
    from htr_vt_torch.models.svtr import SVTR
    from htr_vt_torch.models.van import VANBlock
    biases = set()
    for m in model.modules():
        if isinstance(m, VANBlock):
            biases.add(id(m.proj2.bias))
        elif isinstance(m, SVTR):
            biases |= {id(m.embed_conv1.bias), id(m.embed_conv2.bias)}
    names = {n for n, p in model.named_parameters() if id(p) in biases}
    moments = {f"{i}.{k}" for i, p in enumerate(model.parameters()) if id(p) in biases
               for k in ("exp_avg", "exp_avg_sq")}
    return frozenset(names | moments)


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
    it bit for bit (the CTC class sum runs in a fixed order); under
    deterministic algorithms, "train 6" and "train 3, resume, train 3" held
    bit for bit, and the default-mode run held against them at
    FIT_LOSS_REL, FIT_STATE_L2 and FIT_LEAF_SHARE (cuDNN's default
    algorithms are other ones); best_CER served through ``cli/serve.py``'s
    checkpoint route."""
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
            "run's: " + ("bit-equal (losses, model, EMA, AdamW, step, generator)"
                         if resume["bit_equal"] else f"NOT bit-equal: {gaps(resume)}"))

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
            + f"; the default-mode run against the deterministic one: {gaps(default_det)}"
            f"; {bars}")
        del det_state, det_split_state

        if not held["bit_equal"]:
            raise AssertionError(f"[fit] the deterministic resumed run differs: {held}")
        if not resume["bit_equal"]:
            raise AssertionError(f"[fit] the default-mode resumed run differs: {resume}")
        if not within_bars(default_det):
            raise AssertionError("[fit] the default-mode run against the deterministic "
                                 f"one is outside the bars ({bars}): {default_det}")

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
                          default_resume=resume, deterministic_resume=held,
                          default_vs_deterministic=default_det,
                          loss_rel_bar=FIT_LOSS_REL, state_l2_bar=FIT_STATE_L2,
                          leaf_share_bar=FIT_LEAF_SHARE,
                          imgs_per_sec=rates, peak=peak, wall_s=wall, save_ms=save_ms,
                          restore_ms=restore_ms)


# ---------------------------------------------------------------------------
def _standalone_cfg(name, vocab):
    """The reference recipe of ``name`` (preset, MMS masking, the SGM head
    at ``vocab``), with the fully fused stem switches."""
    return apply_variant_preset(ModelConfig(
        encoder=name, masking=MaskConfig(mode="mms", max_span_length=8),
        sgm=SGMConfig(enable=True, vocab_size=vocab.size, sub_len=SGM_SUB_LEN),
        **FULLY_FUSED))


def phase_zoo_standalone(device, smi_line):
    """Swin, SVTR tiny, van and van2 at 64x512, bf16, seeded weights: a
    counted eval_step at bs 128 (1 K1a, no stem or flash kernel: the
    switches reach none of their stems) against the same weights in
    float32 on the frames whose float32 margin the bf16 rounding cannot
    cross; Swin and SVTR again at 1024 px; then tri-masked SGM SAM steps
    (6 K1a and 6 K1b each, nothing else) and a learning check."""
    vocab = SGMVocab(CTCLabelConverter([chr(c) for c in range(33, 33 + 79)]))
    rng = np.random.default_rng(SEED + 60)
    batch = zoo_batch(BATCH, 512, rng, device)
    wide = zoo_batch(WIDE_BATCH, 1024, rng, device)
    eval_want = {"ctc_alpha": 1}
    per_step = per_step_launches({}, TRI_FORWARDS)
    launches = dict.fromkeys(COUNTERS, 0)
    rec = {}
    for i, name in enumerate(ZOO_STANDALONE):
        cfg = _standalone_cfg(name, vocab)
        serve_cfg = dataclasses.replace(cfg, sgm=SGMConfig())
        model = build_model(serve_cfg, device=device,
                            generator=torch.Generator(device=device).manual_seed(SEED + 60 + i))
        ref32 = build_model(dataclasses.replace(serve_cfg, compute_dtype="float32"),
                            device=device)
        ref32.load_state_dict(model.state_dict(), strict=True)
        say(f"[zoo standalone] {name}: {type(model).__name__}, "
            f"{sum(p.numel() for p in model.parameters())} parameters, bf16, seeded "
            f"weights; stem switches {FULLY_FUSED} (unread by this model's stem)")
        counts, rec[name] = _zoo_case(name, model, model, ref32, batch, eval_want,
                                      "zoo standalone", OWN_OPS)
        launches = {k: launches[k] + counts[k] for k in launches}
        if name in ZOO_STANDALONE_WIDE:
            counts, rec[f"{name}_1024"] = _zoo_case(name, model, model, ref32, wide,
                                                    eval_want, "zoo standalone 1024",
                                                    OWN_OPS)
            launches = {k: launches[k] + counts[k] for k in launches}
        del model, ref32
        torch.cuda.empty_cache()

        # --- the recipe's training, counted -------------------------------------
        exp = ExperimentConfig(model=cfg, optim=OptimConfig(),
                               train=TrainConfig(tri_masked=True))
        state = create_train_state(exp, device,
                                   torch.Generator(device=device).manual_seed(SEED + 70 + i))
        tbatch = sgm_batch(BATCH, 512, LMAX, vocab, rng, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = read_counts()
        times, metrics = _sgm_steps(state, tbatch, ZOO_SAM_WARMUP + ZOO_SAM_STEPS,
                                    per_step, f"zoo standalone train {name}")
        after = read_counts()
        launches = {k: launches[k] + after[k] - before[k] for k in launches}
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(times[ZOO_SAM_WARMUP:])
        del state
        torch.cuda.empty_cache()
        learn = create_train_state(
            dataclasses.replace(exp, optim=OptimConfig(max_lr=3e-4, warmup_iters=5)),
            device, torch.Generator(device=device).manual_seed(SEED + 80 + i))
        small = sgm_batch(LEARN_BATCH, 512, LMAX, vocab, np.random.default_rng(SEED + 81),
                          device)
        losses = [train_step(learn, small)["loss"].item() for _ in range(LEARN_STEPS)]
        del learn
        torch.cuda.empty_cache()
        rec[name].update(train_ms=ms, train_img_s=BATCH / ms * 1e3,
                         train_first_ms=times[0], train_peak_mib=peak / 2**20,
                         train_metrics=metrics, learn_losses=losses)
        say(f"[zoo standalone train] {name}: tri-masked SGM (MMS masking), SAM + AdamW, "
            f"bs {BATCH}: {ZOO_SAM_STEPS} steps after {ZOO_SAM_WARMUP} warm-up, median "
            f"{ms:.3f} ms/step ({BATCH / ms * 1e3:.1f} img/s; first {times[0]:.3f}), peak "
            f"memory {peak / 2**20:.1f} MiB; launches per step {per_step}; loss "
            + " ".join(f"{m['loss']:.4f}" for m in metrics) + "; loss_sgm "
            + " ".join(f"{m['loss_sgm']:.4f}" for m in metrics) + f"; learning check, "
            f"{LEARN_STEPS} steps on one batch of {LEARN_BATCH} (max_lr 3e-4, warmup 5): "
            f"pass-1 loss {losses[0]:.4f} -> {losses[-1]:.4f}; {smi_line}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"[zoo standalone train] {name}: no learning: {losses}")
    say(f"[zoo standalone] {len(ZOO_STANDALONE)} models, launches {launches}")
    return launches, rec


def _ed_cfg(out_dir, exp_name, total, resume=None):
    """run/train_encoder_decoder_iam.sh through the port's argument bridge,
    the trunk fully fused, at bs 128 on in-memory lines (augmentation off:
    no cv2 on the card)."""
    cfg = args_to_config(build_parser("chip_smoke").parse_args(ED_RECIPE))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **FULLY_FUSED),
        data=dataclasses.replace(cfg.data, train_bs=BATCH, val_bs=BATCH, num_workers=4,
                                 augment=AugmentConfig(enable=False)),
        train=TrainConfig(out_dir=out_dir, exp_name=exp_name, seed=SEED, total_iters=total,
                          eval_iters=ED_EVAL, print_iters=ED_EVAL, resume=resume,
                          keep_checkpoints=2))


def _decode_held(model, memory, tin):
    """The cached decode (``decode_one`` position by position on the
    caches) against the uncached ``decode_logits`` over the teacher-forced
    prefix: (largest |dlogits|, argmax agreement)."""
    with torch.inference_mode():
        full = model.decode_logits(memory, tin)
        mem_kvs = model.prefill(memory)
        ks, vs = model.new_caches(tin.shape[0], tin.shape[1], tin.device)
        steps = torch.stack([model.decode_one(tin[:, t], t, mem_kvs, ks, vs)
                             for t in range(tin.shape[1])], dim=1)
    return ((steps - full).abs().max().item(),
            (steps.argmax(-1) == full.argmax(-1)).float().mean().item())


def phase_encoder_decoder(device, smi_line):
    """The IAM encoder-decoder recipe at full width (flagship trunk fully
    fused, 6 decoder layers of 8 heads, max_seq_len 256), bs 128: ``fit``
    for ED_STEPS steps with an EMA ``eval_step_ed`` and a checkpoint every
    ED_EVAL (launches counted exactly: the trunk's K2/K3/K4, no K1 or K5);
    the same run stopped at ED_EVAL and resumed, held bit for bit in
    default mode; then ``eval_step_ed``, greedy and beam generation on one
    batch of 128, and the cached decode against the uncached one."""
    alphabet = [chr(c) for c in range(33, 33 + ModelConfig().nb_cls - 1)]
    datasets = tuple(LineSet(n, alphabet, SEED + 90 + i) for i, n in enumerate(ED_LINES))
    per_step = {k: v for k, v in per_step_launches(FULLY_FUSED).items()
                if not k.startswith("ctc")}
    per_eval = {"pool_bn_relu_fwd": 1, "conv3x3_bn_relu_fwd": 9}
    n_evals, n_val = ED_STEPS // ED_EVAL, math.ceil(ED_LINES[1] / BATCH)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ed_", dir=root)
    say(f"[encoder decoder] loop.fit: {' '.join(ED_RECIPE)}, trunk fully fused, bs "
        f"{BATCH}, {ED_LINES[0]} train and {ED_LINES[1]} val seeded lines (texts of 1-{LMAX} "
        f"characters); total_iters {ED_STEPS}, eval_iters {ED_EVAL}; checkpoints under {tmp}")
    try:
        # --- the main path, counted ------------------------------------------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        events = []
        t0 = time.perf_counter()
        _, full_losses = _recorded_fit(_ed_cfg(tmp, "full", ED_STEPS), datasets, device,
                                       events)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {k: ED_STEPS * per_step.get(k, 0) + n_evals * n_val * per_eval.get(k, 0)
                for k in COUNTERS}
        if launches != want:
            raise AssertionError(f"[encoder decoder] launches {launches}; {ED_STEPS} steps "
                                 f"and {n_evals} x {n_val} eval batches make {want}")
        if not np.isfinite(full_losses).all() or len(full_losses) != ED_STEPS:
            raise AssertionError(f"[encoder decoder] losses {full_losses}")
        times = [a.elapsed_time(b) for a, b in events]
        step_ms = statistics.median(times[1:])
        full_dir = os.path.join(tmp, "full")
        full_state = _final_state(full_dir, ED_STEPS)
        with open(os.path.join(full_dir, "metrics.jsonl")) as f:
            vals = [json.loads(line) for line in f if "val/CER" in line]
        say(f"[encoder decoder] {ED_STEPS} steps + {n_evals} evals in {wall:.3f} s; steps "
            + " ".join(f"{t:.3f}" for t in times) + f" ms (median after the first "
            f"{step_ms:.3f}: {BATCH / step_ms * 1e3:.1f} img/s); pass-1 losses "
            + " ".join(f"{v:.4f}" for v in full_losses) + "; val loss/CER/WER "
            + " ".join(f"{r['val/loss']:.4f}/{r['val/CER']:.4f}/{r['val/WER']:.4f}"
                       for r in vals)
            + f"; peak memory {peak / 2**20:.1f} MiB; launches {launches} = {ED_STEPS} x "
            f"{per_step} + {n_evals * n_val} x {per_eval}; {smi_line}")

        # --- default mode: train ED_EVAL, resume, train the rest ---------------
        _, first = _recorded_fit(_ed_cfg(tmp, "split", ED_EVAL), datasets, device)
        _, resumed = _recorded_fit(_ed_cfg(tmp, "split", ED_STEPS, resume="auto"), datasets,
                                   device)
        split_state = _final_state(os.path.join(tmp, "split"), ED_STEPS)
        resume = compare_states(split_state, full_state, first + resumed, full_losses)
        say(f"[encoder decoder] default mode: train {ED_EVAL}, resume (auto), train "
            f"{ED_STEPS - ED_EVAL}: pass-1 losses "
            + " ".join(f"{v:.4f}" for v in first + resumed) + " against the uninterrupted "
            "run's: " + ("bit-equal (losses, model, EMA, AdamW, step, generator)"
                         if resume["bit_equal"] else f"NOT bit-equal: {gaps(resume)}"))
        if not resume["bit_equal"]:
            raise AssertionError(f"[encoder decoder] the resumed run differs: {resume}")
        del full_state, split_state

        # --- eval_step_ed, generation and the cached decode ----------------------
        model = load_serving_model(os.path.join(full_dir, "best_CER"), None, device)
        tokenizer = EDTokenizer.from_ctc_converter(CTCLabelConverter(sorted(alphabet)))
        val = datasets[1]
        max_len = min(choose_max_label_len(datasets[0].labels, model.cfg.num_tokens) + 2,
                      model.max_seq_len)  # fit's ed_len
        tin, tout, tlen = tokenizer.encode_for_training(val.labels[:BATCH], max_len)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        images = put(np.float32(val.images[:BATCH])[..., None] / 255.0)
        batch = {"image": images, "labels": put(np.zeros((BATCH, 8), np.int32)),
                 "label_lengths": put(np.zeros(BATCH, np.int32)), "ed_input": put(tin),
                 "ed_output": put(tout), "ed_lengths": put(tlen)}
        reset_counts()
        out = eval_step_ed(model, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != {**dict.fromkeys(COUNTERS, 0), **per_eval}:
            raise AssertionError(f"[encoder decoder] eval_step_ed launched {counts}; "
                                 f"expected {per_eval}")
        eval_ms = median_ms(lambda: eval_step_ed(model, batch), 3, warmup=1)
        with torch.inference_mode():
            memory = model.encode(images)
        greedy_ms = median_ms(lambda: generate(model, None, memory=memory,
                                               max_len=max_len), 3, warmup=1)
        beam_ms = median_ms(lambda: generate(model, None, memory=memory, max_len=max_len,
                                             method="beam_search", beam_size=ED_BEAM),
                            3, warmup=1)
        greedy = generate(model, None, memory=memory, max_len=max_len)
        beam = generate(model, None, memory=memory, max_len=max_len,
                        method="beam_search", beam_size=ED_BEAM)
        if not torch.equal(greedy, out["pred_ids"]) or beam.shape != greedy.shape:
            raise AssertionError("[encoder decoder] greedy ids differ from eval_step_ed's")
        bf16_gap, bf16_agree = _decode_held(model, memory, batch["ed_input"])
        ref32 = build_model(dataclasses.replace(model.cfg, compute_dtype="float32"),
                            device=device)
        ref32.load_state_dict(model.state_dict(), strict=True)
        with torch.inference_mode():
            memory32 = ref32.encode(images)
        f32_gap, f32_agree = _decode_held(ref32, memory32, batch["ed_input"])
        del ref32, memory32, model
        torch.cuda.empty_cache()
        say(f"[encoder decoder] EMA best_CER at bs {BATCH}, {max_len} positions: "
            f"eval_step_ed {eval_ms:.3f} ms (launches {counts}: one encode), greedy "
            f"generation {greedy_ms:.3f} ms, beam search (beam {ED_BEAM}) {beam_ms:.3f} ms; "
            f"eval loss {out['loss'].item():.4f}; cached against uncached decode over the "
            f"teacher-forced prefix: bf16 max |dlogits| {bf16_gap:.4e}, argmax agreement "
            f"{bf16_agree:.4%} (floor {ED_DECODE_AGREEMENT:.0%}); float32 copy max |dlogits| "
            f"{f32_gap:.4e} (bar {ED_DECODE_F32_ATOL}), argmax agreement {f32_agree:.4%} "
            f"(floor 100%); {smi_line}")
        if bf16_agree < ED_DECODE_AGREEMENT or f32_agree < 1.0 or \
                not f32_gap <= ED_DECODE_F32_ATOL:
            raise AssertionError("[encoder decoder] the cached decode differs from the "
                                 "uncached one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, dict(step_ms=step_ms, step_times=times, img_s=BATCH / step_ms * 1e3,
                          losses=full_losses, resumed_losses=first + resumed,
                          default_resume=resume, val=vals, peak_mib=peak / 2**20,
                          wall_s=wall, eval_step_ed_ms=eval_ms, greedy_ms=greedy_ms,
                          beam_ms=beam_ms, beam_size=ED_BEAM, positions=max_len,
                          cached_bf16_max_dlogits=bf16_gap, cached_bf16_agreement=bf16_agree,
                          cached_f32_max_dlogits=f32_gap, cached_f32_agreement=f32_agree)


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
def q1_site_inputs(shape, cout, k, kind, device, seed):
    """Q1's inputs at one site: weights of the stem's init scale, quantized
    per output channel from their bf16 cast; an s8 carry with its scale, or
    a bf16 activation (with the folded BN terms for "bf16+bn") and the
    scale of a calibrated abs-max that clips its top 1%."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, c, h, w = shape
    weight = torch.randn(cout, c, k, k, generator=g, device=device) * math.sqrt(
        2.0 / (k * k * cout))
    wq, w_packed, sw = q8.conv_weight(weight.to(torch.bfloat16))
    cl = torch.channels_last
    inp = dict(x=None, xq=None, prologue=None)
    if kind == "s8":
        inp["xq"] = torch.randint(-127, 128, shape, generator=g, device=device,
                                  dtype=torch.int8).contiguous(memory_format=cl)
        sx = torch.tensor(0.02, device=device)
    else:
        x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
        inp["x"] = x.contiguous(memory_format=cl)
        a = x
        if kind == "bf16+bn":
            scale = torch.rand(c, generator=g, device=device) + 0.5
            shift = torch.randn(c, generator=g, device=device) * 0.5
            inp["prologue"] = (scale, shift)
            a = q8.apply_prologue(x, scale, shift)
        amax = torch.quantile(a.float().abs().flatten()[::97], 0.99)
        sx = q8._scale_of(amax)
    return inp, wq, w_packed, sw, sx


def im2col_int_mm(xq, w_packed, stride, padding):
    """The library yardstick of Q1's product: the window rows of the s8
    input gathered by a strided view and copied ([M, kh * kw * Ci]), then
    ``torch._int_mm`` against the packed weight -> s32 [B, Co, Ho, Wo]."""
    co, kh, kw, ci = w_packed.shape
    x = xq.permute(0, 2, 3, 1)  # NHWC view of the channels-last tensor
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    b, h, w, _ = x.shape
    sh, sw = stride
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    s = x.stride()
    cols = x.as_strided((b, ho, wo, kh, kw, ci),
                        (s[0], s[1] * sh, s[2] * sw, s[1], s[2], s[3]))
    acc = torch._int_mm(cols.reshape(b * ho * wo, kh * kw * ci),
                        w_packed.view(co, -1).t())
    return acc.view(b, ho, wo, co).permute(0, 3, 1, 2)


def q1_case(name, shape, cout, k, stride, padding, kind, out_dtype, device, seed):
    """Q1 at one site against its plain twin (the s32 accumulator and the
    output bit-equal), with its device time, the twin's, the yardstick's
    and the bound."""
    inp, wq, w_packed, sw, sx = q1_site_inputs(shape, cout, k, kind, device, seed)
    dq = sx * sw
    with torch.inference_mode():
        def kernel(dtype, x=inp["x"], xq=inp["xq"]):
            return q8.conv_int8_cuda(x, w_packed, sx, dq, stride, padding, dtype,
                                     xq=xq, prologue=inp["prologue"])

        def plain(dtype):
            return q8.conv_int8_reference(inp["x"], wq, sx, dq, stride, padding, dtype,
                                          xq=inp["xq"], prologue=inp["prologue"])

        acc, acc_ref = kernel(torch.int32), plain(torch.int32)
        y, y_ref = kernel(out_dtype), plain(out_dtype)
        y2 = kernel(out_dtype)
        torch.cuda.synchronize()
        acc_equal = torch.equal(acc, acc_ref)
        out_equal = torch.equal(y, y_ref) and torch.equal(y, y2)
        err = (y.float() - y_ref.float()).abs().max().item()
        xq_lib = inp["xq"] if inp["xq"] is not None else q8._quantize(
            q8.apply_prologue(inp["x"], *inp["prologue"]) if inp["prologue"] is not None
            else inp["x"], sx).contiguous(memory_format=torch.channels_last)
        lib_equal = torch.equal(im2col_int_mm(xq_lib, w_packed, stride, padding), acc_ref)
        src = inp["xq"] if inp["xq"] is not None else inp["x"]
        copies = cold_copies(src)
        if inp["xq"] is not None:
            calls = [lambda c=c: kernel(out_dtype, xq=c) for c in copies]
        else:
            calls = [lambda c=c: kernel(out_dtype, x=c) for c in copies]
        ms = device_ms(f"Q1 {name}", calls)
        call_ms = median_ms(lambda: kernel(out_dtype), 10)
        lib_copies = cold_copies(xq_lib)
        lib_ms = device_ms(f"im2col + _int_mm {name}",
                           [lambda c=c: im2col_int_mm(c, w_packed, stride, padding)
                            for c in lib_copies])
        plain_ms = median_ms(lambda: plain(out_dtype), 1, warmup=0)
    route = q8.q1_route(src.dtype, shape[0], shape[1], cout, k, k, stride, padding,
                        y.shape[2], y.shape[3])
    m = y.shape[0] * y.shape[2] * y.shape[3]
    kdim = k * k * shape[1]
    n_bytes = (src.numel() * src.element_size() + w_packed.numel()
               + m * cout * y.element_size())
    bound_ms, bound_by = bound(n_bytes, 2 * m * cout * kdim, INT8_OPS_PER_S)
    rec = dict(shape=list(shape), cout=cout, kernel=k, stride=list(stride), input=kind,
               route=route, out=str(out_dtype).replace("torch.", ""), acc_bit_equal=acc_equal,
               out_bit_equal=out_equal, library_equal=lib_equal, max_abs_err=err,
               max_abs_acc=acc_ref.abs().max().item(), ms=ms, call_ms=call_ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
               bound_by=bound_by, of_bound=bound_ms / ms)
    say(f"[int8 Q1 {name}] {kind} {tuple(shape)} -> {cout}, {k}x{k}/{tuple(stride)}, "
        f"{rec['out']} out, {route} route: s32 acc bit-equal {acc_equal} (max |acc| "
        f"{rec['max_abs_acc']}), out bit-equal {out_equal} (max |err| {err:g}), "
        f"im2col + _int_mm equal {lib_equal}; device {ms:.4f} ms a launch (one call "
        f"{call_ms:.4f}), im2col + _int_mm {lib_ms:.4f} ms, plain twin {plain_ms:.2f} "
        f"ms; bound {bound_ms:.4f} ms ({bound_by}), {rec['of_bound']:.1%} of it")
    if not (acc_equal and out_equal and lib_equal):
        raise AssertionError(f"Q1 at {name}: acc equal {acc_equal}, out equal "
                             f"{out_equal}, library equal {lib_equal}")
    return rec


def is_q1_kernel(kernel):
    """Whether a profiled kernel is one of Q1's (``csrc/conv_int8.cu``: the
    wgmma and gather routes and the quantize kernel)."""
    return short_name(kernel).startswith(("conv_int8_wgmma", "conv_int8_kernel",
                                          "quantize_kernel"))


def int8_logits_held(tag, l8, l32):
    """The int8 logits against float32 ones on the same weights: relative L2
    under JAX's bar, and the frame argmax on the frames whose float32 top-2
    margin is at least twice the int8 noise (the 99th percentile of
    |int8 - float32| over the logits)."""
    rel = ((l8 - l32).norm() / l32.norm()).item()
    noise = torch.quantile((l8 - l32).abs().flatten().float()[::7], 0.99).item()
    top2 = l32.topk(2, dim=-1).values
    decidable = (top2[..., 0] - top2[..., 1]) >= 2 * noise
    held = (l8.argmax(-1)[decidable] == l32.argmax(-1)[decidable]).float().mean().item()
    agree = (l8.argmax(-1) == l32.argmax(-1)).float().mean().item()
    rec = dict(rel_l2=rel, noise=noise, decidable_share=decidable.float().mean().item(),
               decidable_agreement=held, argmax_agreement=agree,
               max_dlogits=(l8 - l32).abs().max().item())
    say(f"[{tag}] int8 vs float32 logits: relative L2 {rel:.4f} (JAX's bar "
        f"{INT8_LOGITS_REL}), max |dlogits| {rec['max_dlogits']:.4f}, int8 noise "
        f"(p99 |dlogits|) {noise:.4f}; frame argmax {agree:.4%} of all frames, "
        f"{held:.4%} of the {rec['decidable_share']:.2%} whose float32 margin is at "
        f"least {2 * noise:.4f} (floor {MIN_ARGMAX_AGREEMENT:.0%})")
    if rel >= INT8_LOGITS_REL or held < MIN_ARGMAX_AGREEMENT or not decidable.any():
        raise AssertionError(f"[{tag}] int8 logits: relative L2 {rel:.4f}, decidable "
                             f"argmax {held:.4%}")
    return rec


def _int8_counted(tag, model, batch, want):
    reset_counts()
    out = eval_step(model, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {**dict.fromkeys(COUNTERS, 0), **want}
    if counts != want:
        raise AssertionError(f"[{tag}] one eval_step launched {counts}; expected {want}")
    if not torch.isfinite(out["logits"]).all() or not torch.isfinite(out["loss"]):
        raise AssertionError(f"[{tag}] non-finite logits or loss")
    return counts, out


def phase_int8_serve(device, smi_line):
    """int8 (A8W8) serving of the flagship and the conformer at full width:
    Q1 against its twin at each site, the counted static eval_step, its
    speed beside the float fully fused one, its logits against float32,
    the pallas-pool and unpadded stems, bucket serving and the conformer."""
    t_phase = time.perf_counter()
    rec = {"sites": {}}
    for i, (name, shape, cout, k, stride, padding, kind, out_dtype, _) in enumerate(
            INT8_SITES):
        rec["sites"][name] = q1_case(name, shape, cout, k, stride, padding, kind,
                                     out_dtype, device, SEED + 300 + i)
    rec["q1_per_forward"] = sum(s[-1] for s in INT8_SITES)
    rec["q1_forward_ms"] = sum(rec["sites"][s[0]]["ms"] * s[-1] for s in INT8_SITES)
    rec["q1_forward_bound_ms"] = sum(rec["sites"][s[0]]["bound_ms"] * s[-1]
                                     for s in INT8_SITES)
    say(f"[int8 Q1] one forward's {rec['q1_per_forward']} Q1 launches (the sites' device "
        f"ms times their launches a forward): {rec['q1_forward_ms']:.4f} ms against a "
        f"summed bound of {rec['q1_forward_bound_ms']:.4f} ms, "
        f"{rec['q1_forward_bound_ms'] / rec['q1_forward_ms']:.1%} of it")

    cfg = ModelConfig()
    cfg8 = dataclasses.replace(cfg, quant="int8")
    float_model = build_model(cfg, device=device,
                              generator=torch.Generator(device=device).manual_seed(SEED))
    sd = float_model.state_dict()

    def int8_model(c):
        model = build_model(c, device=device)
        model.load_state_dict(q8.serving_arrays(c, sd), strict=True)
        return model

    rng = np.random.default_rng(SEED)
    images = line_images(BATCH, rng)  # the serve phase's first batch
    calib = line_images(INT8_CALIB_BATCHES * BATCH, np.random.default_rng(SEED + 19))
    calib_batches = [calib[i:i + BATCH] for i in range(0, len(calib), BATCH)]
    batch = {"image": torch.from_numpy(images).to(device),
             "labels": torch.zeros((BATCH, SERVE_LMAX), dtype=torch.int32, device=device),
             "label_lengths": torch.zeros(BATCH, dtype=torch.int32, device=device)}
    model8 = int8_model(cfg8)
    t0 = time.perf_counter()
    stats = q8.calibrate_quant_stats(model8, calib_batches, INT8_CALIB_BATCHES)
    torch.cuda.synchronize()
    rec["calibrate_s"] = time.perf_counter() - t0
    say(f"[int8 serve] ModelConfig(quant='int8'): stage 1 "
        f"{model8.patch_embed.layer1[0].conv1.weight.shape[0]} wide, quick GELU; "
        f"{len(stats)} sites calibrated on {INT8_CALIB_BATCHES} batches of {BATCH} in "
        f"{rec['calibrate_s']:.3f} s")

    # --- the main path, counted ------------------------------------------
    want = {"ctc_alpha": 1, "conv_int8": rec["q1_per_forward"],
            "int_mm": 4 * cfg.depth}
    counts, out = _int8_counted("int8 serve", model8, batch, want)
    launches = dict(counts)
    torch.cuda.reset_peak_memory_stats()
    rec["eval_ms"] = median_ms(lambda: eval_step(model8, batch), 10)
    rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    rec["img_s"] = BATCH / rec["eval_ms"] * 1e3
    ff = build_model(dataclasses.replace(cfg, **FULLY_FUSED), device=device)
    ff.load_state_dict(sd, strict=True)
    torch.cuda.reset_peak_memory_stats()
    rec["float_fully_fused_eval_ms"] = median_ms(lambda: eval_step(ff, batch), 10)
    rec["float_fully_fused_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    rec["eval_ms_2"] = median_ms(lambda: eval_step(model8, batch), 10)
    say(f"[int8 serve] launches {counts}; static int8 eval_step {rec['eval_ms']:.3f} ms "
        f"({rec['img_s']:.1f} img/s, bs {BATCH}, peak {rec['peak_mib']:.1f} MiB; again "
        f"{rec['eval_ms_2']:.3f} ms); float fully fused eval_step on the same weights "
        f"{rec['float_fully_fused_eval_ms']:.3f} ms ("
        f"{BATCH / rec['float_fully_fused_eval_ms'] * 1e3:.1f} img/s, peak "
        f"{rec['float_fully_fused_peak_mib']:.1f} MiB); {smi_line}")
    del ff
    # where the int8 step's device time goes, by kernel (torch.profiler)
    prof = step_kernel_times(lambda: eval_step(model8, batch))
    by_ms = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][1])
    q1_ms = sum(ms for k, (_, ms) in by_ms if is_q1_kernel(k))
    rec["profile"] = dict(prof, q1_ms=q1_ms,
                          kernels={short_name(k): v for k, v in by_ms[:12]})
    say(f"[int8 serve] one eval_step under torch.profiler (mean of "
        f"{STEP_PROFILE_CALLS}): {prof['kernels_a_call']:g} kernels, "
        f"{prof['busy_ms']:.3f} ms of kernels in a {prof['span_ms']:.3f} ms span; Q1 "
        f"(its wgmma, gather and quantize kernels) {q1_ms:.3f} ms; the 12 longest: "
        + "; ".join(f"{short_name(k)} {ms:.3f} ms x {n:g}" for k, (n, ms) in by_ms[:12]))
    model32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"), device=device)
    model32.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        l32 = model32(batch["image"])
    rec["logits"] = int8_logits_held("int8 serve", out["logits"], l32)

    # --- the pallas-pool stem and the unpadded stage 1 ----------------------
    for tag, c, q1_n, extra in (
            ("pool_impl=pallas", dataclasses.replace(cfg8, pool_impl="pallas"),
             rec["q1_per_forward"], {"pool_bn_relu_fwd": 1}),
            ("quant_stage1_pad=0", dataclasses.replace(cfg8, quant_stage1_pad=0), 8, {})):
        m = int8_model(c)
        q8.calibrate_quant_stats(m, calib_batches, INT8_CALIB_BATCHES)
        counts, o = _int8_counted(f"int8 {tag}", m, batch,
                                  {"ctc_alpha": 1, "conv_int8": q1_n,
                                   "int_mm": 4 * cfg.depth, **extra})
        launches = {k: launches[k] + counts[k] for k in launches}
        r = dict(eval_ms=median_ms(lambda: eval_step(m, batch), 10), launches=counts)
        say(f"[int8 serve {tag}] launches {counts}; eval_step {r['eval_ms']:.3f} ms")
        r["logits"] = int8_logits_held(f"int8 serve {tag}", o["logits"], l32)
        rec[tag] = r
        del m, o
    del model32, l32, out

    # --- bucket serving at int8 (per-bucket calibration) ----------------------
    alphabet = [chr(c) for c in range(33, 33 + cfg.nb_cls - 1)]
    converter = CTCLabelConverter(alphabet)
    chars, widths = selftest_lines(N_LINES, np.random.default_rng(SEED + 5))
    owner = [next((s for s in SERVE_WIDTHS if w <= s), SERVE_WIDTHS[-1]) for w in widths]
    batches = {b: math.ceil(owner.count(b) / BATCH) for b in SERVE_WIDTHS if b in owner}
    n_steps = sum(batches.values())
    wide_fwd = sum(n + min(n, INT8_CALIB_BATCHES) for b, n in batches.items() if b > 512)
    load = lambda i, width: synthetic_line(i, widths[i], width)  # noqa: E731
    reset_counts()
    t0 = time.perf_counter()
    texts = transcribe_buckets(model8, load, widths, SERVE_WIDTHS, converter, BATCH,
                               INT8_CALIB_BATCHES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {**dict.fromkeys(COUNTERS, 0), "ctc_alpha": n_steps,
            "conv_int8": rec["q1_per_forward"] * n_steps, "int_mm": 4 * cfg.depth * n_steps,
            "flash_attention_fwd": cfg.depth * wide_fwd}
    if counts != want:
        raise AssertionError(f"int8 bucket serving launched {counts}; expected {want}")
    if len(texts) != N_LINES or any(t is None for t in texts):
        raise AssertionError(f"{len(texts)} texts for {N_LINES} lines")
    launches = {k: launches[k] + counts[k] for k in launches}
    rec["bucket_serve"] = dict(batches=batches, wall_s=wall, launches=counts)
    say(f"[int8 bucket serve] {N_LINES} lines in {batches} batches at "
        f"{SERVE_WIDTHS} px, each bucket calibrated on its first "
        f"{INT8_CALIB_BATCHES} batches: {wall:.3f} s (first calls included); "
        f"launches {counts} (K5f {cfg.depth} a forward at 1024 and 2048 px, "
        "calibration forwards included)")
    del model8, float_model

    # --- the int8 conformer ------------------------------------------------
    ccfg = apply_variant_preset(dataclasses.replace(cfg, encoder="conformer"))
    cgen = torch.Generator(device=device).manual_seed(SEED + 7)
    conf = build_model(ccfg, device=device, generator=cgen)
    csd = conf.state_dict()
    conf8 = build_model(dataclasses.replace(ccfg, quant="int8"), device=device)
    conf8.load_state_dict(q8.serving_arrays(conf8.cfg, csd), strict=True)
    q8.calibrate_quant_stats(conf8, calib_batches, INT8_CALIB_BATCHES)
    counts, o = _int8_counted("int8 conformer", conf8, batch,
                              {"ctc_alpha": 1, "conv_int8": rec["q1_per_forward"],
                               "int_mm": 8 * ccfg.depth})
    launches = {k: launches[k] + counts[k] for k in launches}
    conf32 = build_model(dataclasses.replace(ccfg, compute_dtype="float32"), device=device)
    conf32.load_state_dict(csd, strict=True)
    with torch.inference_mode():
        c32 = conf32(batch["image"])
    r = dict(eval_ms=median_ms(lambda: eval_step(conf8, batch), 10), launches=counts)
    r["float_eval_ms"] = median_ms(lambda: eval_step(conf, batch), 10)
    say(f"[int8 conformer] launches {counts}; int8 eval_step {r['eval_ms']:.3f} ms "
        f"({BATCH / r['eval_ms'] * 1e3:.1f} img/s); float (stock ops) "
        f"{r['float_eval_ms']:.3f} ms")
    r["logits"] = int8_logits_held("int8 conformer", o["logits"], c32)
    rec["conformer"] = r
    del conf, conf8, conf32, o, c32
    rec["phase_s"] = time.perf_counter() - t_phase
    say(f"[int8 serve] phase {rec['phase_s']:.1f} s")
    return launches, rec

def _program_launches(tag, fn, x, want):
    """One call of an exported program on device-resident ``x``, counted:
    exactly ``want`` of the kernels, nothing else (``_int_mm`` is an ATen
    op inside the program, so its wrapper counts nothing there)."""
    reset_counts()
    with torch.no_grad():
        ids, lengths = fn(x)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {**dict.fromkeys(COUNTERS, 0), **want}
    if counts != want:
        raise AssertionError(f"[{tag}] one program call launched {counts}; expected {want}")
    return counts, ids, lengths


def _held_to_live(tag, got, live):
    """ids and lengths of a program call bit-equal to the live model's."""
    for name, g, w in zip(("ids", "lengths"), got, live):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"[{tag}] program {name} differ from the live model's "
                                 f"({int((g != w).sum())} of {g.numel()} entries)")


def _http_get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def phase_deploy_serve(device, smi_line):
    """Deploy and serve: the flagship fully fused exported through
    ``torch.export`` at the serving buckets and at int8, reloaded as a
    ``ServingBundle`` (no model code), held bit for bit to the live model,
    its kernels counted per program call; the program's time beside the
    live ``eval_step``; ``BatchWorker`` from threads; ``cli/export.py`` and
    ``cli/server.py`` as a user runs them; beam + n-gram LM rescoring."""
    t_phase = time.perf_counter()
    rec = {"widths": {}}
    cfg = dataclasses.replace(ModelConfig(), **FULLY_FUSED)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(SEED))
    model.eval()
    sd = model.state_dict()
    cfg8 = ModelConfig(quant="int8")
    model8 = build_model(cfg8, device=device)
    model8.load_state_dict(q8.serving_arrays(cfg8, sd), strict=True)
    calib = line_images(INT8_CALIB_BATCHES * BATCH, np.random.default_rng(SEED + 19))
    q8.calibrate_quant_stats(model8, [calib[i:i + BATCH] for i in range(0, len(calib), BATCH)],
                             INT8_CALIB_BATCHES)
    model8.eval()
    alphabet = [chr(c) for c in range(33, 33 + cfg.nb_cls - 1)]
    converter = CTCLabelConverter(alphabet)
    meta = {"charset": converter.character, "height": 64, "batch_size": BATCH,
            "encoder": cfg.encoder, "device": device.type}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_", dir=root)
    server = None
    try:
        # --- export, save, reload -------------------------------------------
        programs, export_s = {}, {}
        for width in DEPLOY_WIDTHS:
            t0 = time.perf_counter()
            programs[width] = export_serving(model, BATCH, (64, width))
            export_s[width] = time.perf_counter() - t0
        t0 = time.perf_counter()
        program8 = export_serving(model8, BATCH, (64, 512))
        export_s["int8"] = time.perf_counter() - t0
        float_dir, int8_dir = os.path.join(tmp, "float"), os.path.join(tmp, "int8")
        rec["bundle_mb"] = save_bundle(float_dir, programs, dict(meta, quant="float")) / 1e6
        rec["int8_bundle_mb"] = save_bundle(int8_dir, {512: program8},
                                            dict(meta, quant="int8")) / 1e6
        held = {w: sorted({str(n.target) for n in p.graph.nodes
                           if str(n.target).startswith("htrvt.")})
                for w, p in {**programs, "int8": program8}.items()}
        del programs, program8
        t0 = time.perf_counter()
        bundle, bundle8 = ServingBundle(float_dir), ServingBundle(int8_dir)
        rec["load_s"] = time.perf_counter() - t0
        rec["export_s"] = export_s
        say(f"[deploy] exported the flagship fully fused at {list(DEPLOY_WIDTHS)} px and "
            f"int8 at 512 px, bs {BATCH}: export "
            + ", ".join(f"{w} {t:.1f} s" for w, t in export_s.items())
            + f"; bundles {rec['bundle_mb']:.1f} MB (float, {len(DEPLOY_WIDTHS)} programs) "
            f"and {rec['int8_bundle_mb']:.1f} MB (int8), written under {tmp}; reloaded "
            f"in {rec['load_s']:.1f} s; ops in the programs {held}")

        # --- the main path, counted: one program call a width -----------------
        launches = dict.fromkeys(COUNTERS, 0)
        per_eval = {k: v for k, v in per_eval_launches(FULLY_FUSED).items()
                    if k != "ctc_alpha"}
        chars, widths = selftest_lines(N_LINES, np.random.default_rng(SEED + 5))
        cases = [(w, bundle, model, w, dict(per_eval, **(
            {"flash_attention_fwd": cfg.depth} if w > 512 else {})))
            for w in DEPLOY_WIDTHS]
        cases.append(("int8", bundle8, model8, 512,
                      {"conv_int8": sum(site[-1] for site in INT8_SITES)}))
        for tag, b, live_model, width, want in cases:
            owner = [i for i, w in enumerate(widths)
                     if next((s for s in SERVE_WIDTHS if w <= s), SERVE_WIDTHS[-1]) == width]
            rows = (owner * BATCH)[:BATCH]
            img = np.stack([synthetic_line(i, widths[i], width) for i in rows])
            x = torch.from_numpy(img).to(device)
            fn = b._fns[width]
            counts, ids, lengths = _program_launches(f"deploy {tag}", fn, x, want)
            launches = {k: launches[k] + counts[k] for k in launches}
            with torch.no_grad():
                live = make_serving_fn(live_model)(x)
            _held_to_live(f"deploy {tag}", (ids, lengths), live)
            batch = {"image": x, "labels": torch.zeros((BATCH, SERVE_LMAX), dtype=torch.int32,
                                                       device=device),
                     "label_lengths": torch.zeros(BATCH, dtype=torch.int32, device=device)}
            with torch.no_grad():
                mem0 = torch.cuda.memory_stats()
                r = dict(launches=counts,
                         program_ms=median_ms(lambda: fn(x), 10),
                         live_fn_ms=median_ms(lambda: make_serving_fn(live_model)(x), 10),
                         eval_step_ms=median_ms(lambda: eval_step(live_model, batch), 10),
                         bundle_run_ms=median_ms(lambda: b.run(img, width), 5),
                         program_ms_2=median_ms(lambda: fn(x), 10))
                mem1 = torch.cuda.memory_stats()
                # the device's busy share of a call, program and live
                prof = {k: step_kernel_times(f) for k, f in (
                    ("program", lambda: fn(x)),
                    ("live_fn", lambda: make_serving_fn(live_model)(x)))}
            r["allocator"] = {k: mem1.get(k, 0) - mem0.get(k, 0) for k in (
                "num_alloc_retries", "num_device_alloc", "num_device_free")}
            r["profile"] = {k: {f: v[f] for f in ("kernels_a_call", "busy_ms", "span_ms")}
                            for k, v in prof.items()}
            r["mean_length"] = float(lengths.float().mean())
            rec["widths"][str(tag)] = r
            say(f"[deploy {tag}] program call launched "
                f"{ {k: v for k, v in counts.items() if v} } (the live eval_step's "
                f"kernels less K1a); ids and lengths bit-equal to the live model; program "
                f"{r['program_ms']:.3f} / {r['program_ms_2']:.3f} ms, live serving fn "
                f"{r['live_fn_ms']:.3f} ms, live eval_step {r['eval_step_ms']:.3f} ms, "
                f"ServingBundle.run (numpy in and out) {r['bundle_run_ms']:.3f} ms "
                f"({BATCH / r['program_ms'] * 1e3:.1f} img/s by the program); under "
                f"torch.profiler {r['profile']}; allocator over the timed calls "
                f"{r['allocator']}; {smi_line}")

        # --- BatchWorker from threads --------------------------------------------
        worker = BatchWorker(bundle, DEPLOY_WAIT_MS)
        worker.start()
        lines = line_images(DEPLOY_LINES, np.random.default_rng(SEED + 40))
        pending = [None] * DEPLOY_LINES

        def client(k):
            for i in range(k, DEPLOY_LINES, DEPLOY_THREADS):
                pending[i] = worker.submit(lines[i], 512)
                if not pending[i].event.wait(600):
                    raise AssertionError(f"line {i} was not served")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(DEPLOY_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        worker_s = time.perf_counter() - t0
        worker.stop()
        worker.join(timeout=60)
        errors = [p.error for p in pending if p.error is not None]
        if errors:
            raise AssertionError(f"[deploy worker] {len(errors)} requests failed: {errors[:3]}")
        want_texts = bundle.transcribe(lines)
        if [p.text for p in pending] != want_texts:
            raise AssertionError("[deploy worker] texts differ from ServingBundle.transcribe")
        if not worker.batches < DEPLOY_LINES:
            raise AssertionError(f"[deploy worker] {worker.batches} program calls for "
                                 f"{DEPLOY_LINES} requests")
        rec["worker"] = dict(lines=DEPLOY_LINES, threads=DEPLOY_THREADS,
                             batches=worker.batches, wall_s=worker_s)
        say(f"[deploy worker] {DEPLOY_LINES} numpy lines from {DEPLOY_THREADS} threads in "
            f"{worker.batches} program calls ({DEPLOY_WAIT_MS:.0f} ms window), "
            f"{worker_s:.3f} s ({DEPLOY_LINES / worker_s:.1f} lines/s, first calls "
            f"included); texts equal to ServingBundle.transcribe's")

        # --- beam + n-gram LM rescoring on the host ------------------------------
        lm_rng = np.random.default_rng(SEED + 50)
        words = ["".join(lm_rng.choice(alphabet, lm_rng.integers(2, 8)))
                 for _ in range(300)]
        corpus = [" ".join(lm_rng.choice(words, lm_rng.integers(3, 12)))
                  for _ in range(DEPLOY_LM_LINES)]
        arpa = os.path.join(tmp, "word3.arpa")
        t0 = time.perf_counter()
        train_ngram_arpa(corpus, arpa, order=3, level="word")
        train_s = time.perf_counter() - t0
        scorer = NgramScorer(arpa)
        route = "native (C++)" if scorer._handle else "pure Python"
        img = line_images(BATCH, np.random.default_rng(SEED))
        x = torch.from_numpy(img).to(device)
        with torch.no_grad():
            logits = model(x)
        greedy = converter.decode_batch(logits.argmax(-1).to(torch.int32).cpu().numpy())
        t0 = time.perf_counter()
        texts = beam_lm_texts(logits, greedy, converter, scorer, DEPLOY_BEAM,
                              DEPLOY_LM_WEIGHT)
        beam_s = time.perf_counter() - t0
        if len(texts) != BATCH or any(t is None for t in texts):
            raise AssertionError("[deploy lm] beam rescoring lost lines")
        rec["lm"] = dict(scorer=route, native_lib=load_native() is not None,
                         train_s=train_s, beam_s=beam_s, lines=BATCH,
                         changed=sum(a != b for a, b in zip(texts, greedy)))
        say(f"[deploy lm] word trigram from lm_train on {DEPLOY_LM_LINES} synthetic lines "
            f"({train_s:.2f} s); scorer: {route}; prefix beam {DEPLOY_BEAM} + LM rescoring "
            f"(weight {DEPLOY_LM_WEIGHT}) of {BATCH} lines on the host in {beam_s:.3f} s "
            f"({BATCH / beam_s:.1f} lines/s); {rec['lm']['changed']} lines differ from "
            "greedy")

        # --- the CLIs as a user runs them ------------------------------------------
        ckpt_root = os.path.join(tmp, "run")
        argv = [*DEPLOY_CLI, "--device", device.type]
        ecfg = args_to_config(build_parser("chip_smoke").parse_args(argv))
        econv = make_converter(ecfg.data, build_dataset(ecfg.data, "train"))
        ecfg = dataclasses.replace(ecfg, model=dataclasses.replace(
            ecfg.model, nb_cls=econv.num_classes))
        state = create_train_state(ecfg, device,
                                   torch.Generator(device=device).manual_seed(SEED + 60))
        CheckpointManager(ckpt_root).save(state, cer=1.0, wer=1.0, best_cer=1.0,
                                          best_wer=1.0, meta={"config": config_to_dict(ecfg)})
        del state
        cli_dir = os.path.join(tmp, "cli_bundle")
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            cli_export.main([*argv, "--checkpoint", os.path.join(ckpt_root, "best_CER"),
                             "--out", cli_dir, "--width-buckets",
                             ",".join(map(str, DEPLOY_WIDTHS)), "--batch-size", str(BATCH),
                             "--verify"])
        cli_s = time.perf_counter() - t0
        out = printed.getvalue()
        if out.count("OK (bit-exact vs live model)") != len(DEPLOY_WIDTHS):
            raise AssertionError(f"[deploy cli] export --verify printed:\n{out}")
        for line in out.splitlines():
            say(f"[deploy cli] {line}")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        server = subprocess.Popen(
            [sys.executable, "-m", "htr_vt_torch.cli.server", "--bundle", cli_dir,
             "--port", str(port)], cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        health = None
        while time.perf_counter() - t0 < 300 and server.poll() is None:
            try:
                health = _http_get(f"http://127.0.0.1:{port}/healthz")
                break
            except OSError:
                time.sleep(1.0)
        up_s = time.perf_counter() - t0
        if health is None or health.get("status") != "ok" or \
                health.get("widths") != list(DEPLOY_WIDTHS):
            server.kill()
            raise AssertionError(f"[deploy cli] server: /healthz {health}; output "
                                 f"{server.communicate(timeout=60)[0][-3000:]}")
        rec["cli"] = dict(export_verify_s=cli_s, server_up_s=up_s, healthz=health)
        say(f"[deploy cli] python -m htr_vt_torch.cli.export {' '.join(DEPLOY_CLI)} (stock "
            f"stem switches) --width-buckets {','.join(map(str, DEPLOY_WIDTHS))} --verify: "
            f"{cli_s:.1f} s; python -m htr_vt_torch.cli.server --bundle: /healthz after "
            f"{up_s:.1f} s: {health}")
    finally:
        if server is not None and server.poll() is None:
            server.terminate()
            try:
                server.wait(timeout=60)
            except subprocess.TimeoutExpired:
                server.kill()
                server.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    say(f"[deploy] phase {rec['phase_s']:.1f} s; {smi_line}")
    return launches, rec



# ---------------------------------------------------------------------------
def lever_launches(remat, accum, flash=0, forwards=1, switches=FULLY_FUSED):
    """Launches a SAM step under ``remat`` and ``grad_accum``: the step's
    (``per_step_launches``; ``flash`` K5 launches of each kind), "all"
    running the stem's forward kernels again in the backward's recompute
    (K2, K3f, K4f twice) and "blocks" / "all" the blocks' K5f, and every
    kernel ``accum`` times on a batch ``accum`` times smaller."""
    want = per_step_launches(switches, forwards)
    if flash:
        want.update(flash_attention_fwd=flash, flash_attention_bwd_dkv=flash,
                    flash_attention_bwd_dq=flash)
    if remat == "all":
        for k in ("bn_stats", "pool_bn_relu_fwd", "conv3x3_bn_relu_fwd"):
            if k in want:
                want[k] *= 2
    if remat in ("blocks", "all") and flash:
        want["flash_attention_fwd"] *= 2
    return {k: n * accum for k, n in want.items()}


def recompute_culprits(device):
    """The forward kernels of the stem (and the cuDNN conv beside them) whose
    second call on the same input gives other bits: what a remat recompute
    could not repeat."""
    x = stem_input((BATCH, 192, 32, 512), device, SEED + 95)
    scale = torch.rand(192, device=device) + 0.5
    shift = torch.rand(192, device=device) - 0.5
    y = stem_input((BATCH, 192, 8, 512), device, SEED + 96)
    k = (0.05 * torch.randn(192, 192, 3, 3, device=device)).to(torch.bfloat16)
    calls = {"bn_stats (K2)": lambda: bn_stats(x),
             "pool_bn_relu_fwd (K3f)": lambda: (pool_fused.pool_bn_relu_fwd(x, scale, shift),),
             "conv3x3_bn_relu_fwd (K4f)": lambda: (conv_fused.conv3x3_bn_relu_fwd(
                 y, k, scale, shift),),
             "cuDNN F.conv2d": lambda: (F.conv2d(y, k, padding=1),)}
    out = []
    for name, fn in calls.items():
        a, b = fn(), fn()
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            out.append(name)
    return out


def _lever_row(tag, cfg, batch, want, device, seed, smi_line, steps=LEVER_STEPS):
    """One memory-lever row: a state from ``seed``, LEVER_WARMUP + ``steps``
    counted SAM steps on ``batch``; each step's launches held to ``want``;
    ms/step (median of the timed steps, CUDA events), the peak memory (and
    the part of it above what the process held before the row's state was
    made, which earlier phases leave behind), every step's metrics and the
    final weights."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    state = create_train_state(cfg, device, torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for _ in range(LEVER_WARMUP + steps):
        before = read_counts()
        start, end = _events()
        start.record()
        m = train_step(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        after = read_counts()
        step = {k: after[k] - before[k] for k in after}
        if step != {**dict.fromkeys(COUNTERS, 0), **want}:
            raise AssertionError(f"[{tag}] a step launched {step}; predicted {want}")
        metrics.append({k: v.item() for k, v in m.items()})
        if not all(math.isfinite(v) for v in metrics[-1].values()):
            raise AssertionError(f"[{tag}] metrics {metrics[-1]}")
    peak = torch.cuda.max_memory_allocated()
    # on the host, out of the next rows' peaks
    weights = {k: v.cpu() for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    ms = statistics.median(times[LEVER_WARMUP:])
    b = batch["image"].shape[0]
    say(f"[{tag}] {steps} steps after {LEVER_WARMUP} warm-up: median {ms:.3f} ms/step "
        f"({b / ms * 1e3:.1f} img/s), peak memory {peak / 2**20:.1f} MiB, "
        f"{(peak - held) / 2**20:.1f} MiB of it the row's own; launches a step "
        f"{want} (as predicted); first pass-1 loss {metrics[0]['loss']:.6f}, grad_norm "
        f"{metrics[0]['grad_norm']:.6f}; {smi_line}")
    return dict(ms=ms, peak_mib=peak / 2**20, row_peak_mib=(peak - held) / 2**20,
                times=times, metrics=metrics, launches_a_step=want), weights


def _same_bits(tag, rec, weights, plain, plain_weights, device):
    """A remat row against the plain row: every metric of every step and the
    final weights bit for bit, or the kernel whose recompute differs named
    and the phase failed."""
    same = rec["metrics"] == plain["metrics"] and all(
        torch.equal(v, plain_weights[k]) for k, v in weights.items())
    if not same:
        culprits = recompute_culprits(device)
        raise AssertionError(
            f"[{tag}] the remat step is not bit-equal to the plain step; second calls "
            "that differ: " + (", ".join(culprits) or "none (the recompute's inputs "
                                                      "differ)"))
    say(f"[{tag}] losses, loss_second, grad_norm of all {len(rec['metrics'])} steps and "
        "the final weights bit-equal to the plain step's")


def phase_memory_levers(device, smi_line, fully_fused_ms):
    """remat and grad_accum on the fully fused flagship at bs 128 and 512 px
    (LEVER_ROWS), the 2048-px step at bs 64 plain and under remat "all",
    and the tri-masked SGM SVTR under grad_accum SVTR_ACCUM: per row ms/step,
    peak memory, launches a step held to ``lever_launches``, the first
    pass-1 loss and grad_norm; the remat rows bit-equal to the plain row."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(COUNTERS, 0)
    rec = {"flagship": {}, "wide2048": {}}
    model_cfg = ModelConfig(masking=MaskConfig(mode="span", ratio=0.4, max_span_length=8),
                            **FULLY_FUSED)
    batch = train_batch(BATCH, model_cfg, np.random.default_rng(SEED + 90), device,
                        infeasible=8)
    say(f"[memory levers] fully fused flagship bf16, bs {BATCH}, 512 px, IAM span "
        f"masking; rows (remat, grad_accum) {LEVER_ROWS}; the step without a lever "
        f"peaked at {UNLEVERED_PEAK_MIB['flagship']} MiB before the levers; {smi_line}")
    plain = None
    for remat, accum in LEVER_ROWS:
        tag = f"memory levers remat={remat} accum={accum}"
        cfg = ExperimentConfig(model=dataclasses.replace(model_cfg, remat=remat),
                               optim=OptimConfig(), train=TrainConfig(grad_accum=accum))
        before = read_counts()
        row, weights = _lever_row(tag, cfg, batch, lever_launches(remat, accum), device,
                                  SEED + 91, smi_line)
        launches = {k: launches[k] + read_counts()[k] - before[k] for k in launches}
        if (remat, accum) == ("none", 1):
            plain, plain_weights = row, weights
            row["vs_fully_fused_train_ms"] = row["ms"] / fully_fused_ms
            say(f"[{tag}] the step without a lever: {row['ms']:.3f} ms against the fully "
                f"fused train phase's {fully_fused_ms:.3f} ms on this run "
                f"({row['ms'] / fully_fused_ms - 1:+.2%})")
        elif accum == 1:
            _same_bits(tag, row, weights, plain, plain_weights, device)
        del weights
        rec["flagship"][f"{remat}_{accum}"] = {k: v for k, v in row.items() if k != "times"}
    del plain_weights

    # --- 2048 px, bs 64: K5 in the blocks, recomputed under remat -------------
    wide = wide_batch(WIDE_BATCH, 2048, np.random.default_rng(SEED + 92), device)
    flash = 2 * model_cfg.depth
    wide_plain = None
    for remat, accum in WIDE_LEVER_ROWS:
        tag = f"memory levers 2048 remat={remat}"
        cfg = ExperimentConfig(model=dataclasses.replace(model_cfg, remat=remat),
                               optim=OptimConfig())
        before = read_counts()
        row, weights = _lever_row(tag, cfg, wide, lever_launches(remat, accum, flash),
                                  device, SEED + 93, smi_line)
        launches = {k: launches[k] + read_counts()[k] - before[k] for k in launches}
        if remat == "none":
            wide_plain, wide_weights = row, weights
        else:
            _same_bits(tag, row, weights, wide_plain, wide_weights, device)
        say(f"[{tag}] the row's own peak {row['row_peak_mib']:.1f} MiB beside the "
            f"stock-stem 2048-px step's {UNLEVERED_PEAK_MIB['wide2048']} MiB")
        del weights
        rec["wide2048"][remat] = {k: v for k, v in row.items() if k != "times"}
    del wide_weights, wide

    # --- the tri-masked SGM SVTR under grad_accum (remat is not read by SVTR) --
    vocab = SGMVocab(CTCLabelConverter([chr(c) for c in range(33, 33 + 79)]))
    exp = ExperimentConfig(model=_standalone_cfg("svtr", vocab), optim=OptimConfig(),
                           train=TrainConfig(tri_masked=True, grad_accum=SVTR_ACCUM))
    sbatch = sgm_batch(BATCH, 512, LMAX, vocab, np.random.default_rng(SEED + 94), device)
    tag = f"memory levers svtr accum={SVTR_ACCUM}"
    before = read_counts()
    row, weights = _lever_row(tag, exp, sbatch,
                              lever_launches("none", SVTR_ACCUM, forwards=TRI_FORWARDS,
                                             switches={}), device, SEED + 97, smi_line)
    launches = {k: launches[k] + read_counts()[k] - before[k] for k in launches}
    del weights
    say(f"[{tag}] tri-masked SGM SVTR, bs {BATCH}: the row's own peak "
        f"{row['row_peak_mib']:.1f} MiB beside {UNLEVERED_PEAK_MIB['svtr']} MiB without "
        "accumulation")
    rec["svtr_accum"] = {k: v for k, v in row.items() if k != "times"}
    rec["unlevered_peak_mib"] = UNLEVERED_PEAK_MIB
    say(f"[memory levers] phase {time.perf_counter() - t_phase:.1f} s; launches {launches}; "
        f"{smi_line}")
    return launches, rec


def _dp_cfg(dtype):
    return ExperimentConfig(model=ModelConfig(compute_dtype=dtype, masking=MaskConfig(
        mode="span", ratio=0.4, max_span_length=8), **FULLY_FUSED), optim=OptimConfig())


def _dp_batch(device):
    return train_batch(BATCH, _dp_cfg("bfloat16").model, np.random.default_rng(SEED + 101),
                       device, infeasible=8)


def _dp_state_file(state):
    """A state as ``compare_states`` reads a checkpoint's, on the host."""
    host = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    return {"model": host(state.model.state_dict()),
            "ema_model": host(state.ema_model.state_dict()),
            "optimizer": {"state": {i: host(st) for i, st in
                                    state.optimizer.state_dict()["state"].items()}},
            "step": state.step, "generator": state.generator.get_state()}


def _dp_steps(state, batch, dtype):
    """DP_STEPS counted steps (under deterministic algorithms for a dtype
    of DP_DETERMINISTIC): (metrics, launches, CUDA-event ms a step)."""
    reset_counts()
    times, metrics = [], []
    with (deterministic_algorithms() if dtype in DP_DETERMINISTIC
          else contextlib.nullcontext()):
        for _ in range(DP_STEPS):
            start, end = _events()
            start.record()
            m = train_step(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            metrics.append({k: v.item() for k, v in m.items()})
    return metrics, read_counts(), times


def dp_worker(out_dir):
    """One rank of phase 22 (``python3 chip_smoke.py --data-parallel-rank
    DIR``, launched by ``phase_data_parallel`` with the ``HTRVT_*``
    variables): the fully fused step, in each of DP_DTYPES, on its rows of
    the global batch over a gloo group that shares card 0 with the other
    rank."""
    from htr_vt_torch.parallel import mesh
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.maybe_initialize_distributed(backend="gloo")
    rank, size = mesh.world()
    _build.library()
    # the other helpers on CUDA tensors over gloo (validate, the resume path)
    rows = mesh.all_gather_rows(torch.full((2,), float(rank), device=device))
    said = mesh.broadcast_str("from rank 0" if rank == 0 else None)
    if rows.tolist() != [float(r) for r in range(size) for _ in range(2)] or \
            said != "from rank 0":
        raise AssertionError(f"rank {rank}: gathered {rows.tolist()}, broadcast {said!r}")
    batch = _dp_batch(device)
    b = BATCH // size
    mine = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
    out = {"world": (rank, size)}
    for dtype in DP_DTYPES:
        state = create_train_state(_dp_cfg(dtype), device,
                                   torch.Generator(device=device).manual_seed(SEED + 100))
        metrics, launches, times = _dp_steps(state, mine, dtype)
        out[dtype] = {"metrics": metrics, "launches": launches, "times": times,
                      "state": _dp_state_file(state)}
        del state
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.barrier()
    torch.distributed.destroy_process_group()


def run_ranks(flag, out_dir, n, timeout, tag):
    """``python3 chip_smoke.py <flag> out_dir`` as n ranks of one gloo group
    (the ``HTRVT_*`` launch), each under ``timeout``; the ``rank{r}.pt``
    each saved in ``out_dir``. A rank that fails or hangs fails the phase
    with every rank's output."""
    with socket.socket() as sock:
        sock.bind(("", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(n):
        env = dict(os.environ, HTRVT_COORDINATOR=f"localhost:{port}",
                   HTRVT_NUM_PROCESSES=str(n), HTRVT_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], False
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0] + f"\n[rank {rank}: timed out]"
            failed = True
        failed |= p.returncode != 0
        logs.append(f"--- rank {rank} (rc {p.returncode}) ---\n{out[-4000:]}")
    if failed:
        raise AssertionError(f"[{tag}] a rank failed:\n" + "\n".join(logs))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def held_to_one(got, ref, bars, noise_leaves=frozenset()):
    """Ranks' run (``got``: metrics a step and the state) against one
    process's at ``bars`` (DP_BARS' keys): (within the bars, the relative
    gaps a step, ``compare_states``; ``noise_leaves`` as there)."""
    held = compare_states(got["state"], ref["state"], [m["loss"] for m in got["metrics"]],
                          [m["loss"] for m in ref["metrics"]], noise_leaves)
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got["metrics"], ref["metrics"])]
           for k in ("loss", "loss_second", "grad_norm")}
    ok = (max(rel["loss"] + rel["loss_second"]) <= bars["loss"]
          and max(rel["grad_norm"]) <= bars["grad_norm"]
          and max(rel["loss"][0], rel["loss_second"][0]) <= bars["first_loss"]
          and rel["grad_norm"][0] <= bars["first_grad_norm"]
          and held["generator_equal"] and held["step"][0] == held["step"][1]
          and all(held[f"{p}_l2"] <= bar for p, bar in bars["state"].items())
          and all(held[f"{p}_leaf"][0] <= FIT_LEAF_SHARE for p in bars["state"]))
    return ok, rel, held


def warm_ms(times):
    """(the median of a run's steps after its first, the first step's ms):
    a step's time once its first call's costs are paid, beside that first
    step (``phase_multiwidth``'s reading)."""
    return statistics.median(times[1:]), times[0]


def phase_data_parallel(device, smi_line):
    """Two ranks on the one card over gloo (``dp_worker``, bs 64 each, the
    fully fused step, bf16 and float32) against one process at bs 128 on
    the same weights, batch and masks, held at DP_BARS; each rank's
    launches; then ``fit`` in a world of one over NCCL (the production
    backend's init) and one all-reduce of a device tensor on it."""
    from htr_vt_torch.parallel import mesh
    t_phase = time.perf_counter()
    rec = {}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=root)
    try:
        # --- one process at bs 128: the references, counted -----------------------
        per_step = per_step_launches(FULLY_FUSED)
        want = {**dict.fromkeys(COUNTERS, 0), **{k: n * DP_STEPS for k, n in per_step.items()}}
        one = {}
        launches = dict.fromkeys(COUNTERS, 0)
        for dtype in DP_DTYPES:
            state = create_train_state(_dp_cfg(dtype), device,
                                       torch.Generator(device=device).manual_seed(SEED + 100))
            metrics, counts, times = _dp_steps(state, _dp_batch(device), dtype)
            one[dtype] = {"metrics": metrics, "times": times, "state": _dp_state_file(state)}
            del state
            torch.cuda.empty_cache()
            if counts != want:
                raise AssertionError(f"[data parallel] one process launched {counts}; "
                                     f"expected {want}")
            launches = {k: launches[k] + counts[k] for k in launches}

        # --- two ranks on the card over gloo -----------------------------------
        ranks = run_ranks("--data-parallel-rank", tmp, DP_RANKS, DP_TIMEOUT, "data parallel")
        say("[data parallel] gloo took the CUDA tensors of all_reduce, all_gather, "
            "broadcast and barrier on both ranks")
        for dtype in DP_DTYPES:
            got, ref, bars = ranks[0][dtype], one[dtype], DP_BARS[dtype]
            for r in ranks[1:]:
                if r[dtype]["metrics"] != got["metrics"] or any(
                        not torch.equal(v, r[dtype]["state"]["model"][k])
                        for k, v in got["state"]["model"].items()):
                    raise AssertionError(f"[data parallel] {dtype}: the ranks' metrics or "
                                         "weights differ")
                if r[dtype]["launches"] != want:
                    raise AssertionError(f"[data parallel] {dtype}: rank {r['world'][0]} "
                                         f"launched {r[dtype]['launches']}; expected {want}")
            ok, rel, held = held_to_one(got, ref, bars)
            say(f"[data parallel {dtype}] {DP_RANKS} ranks on one card over gloo, bs "
                f"{BATCH // DP_RANKS} each, {DP_STEPS} fully fused steps, against one "
                f"process at bs {BATCH} on the same weights, batch and masks: relative gaps "
                "a step " + "; ".join(f"{k} " + " ".join(f"{v:.3e}" for v in vs)
                                      for k, vs in rel.items())
                + f" (bars: the first step's losses {bars['first_loss']} and grad_norm "
                f"{bars['first_grad_norm']}, every step's {bars['loss']} and "
                f"{bars['grad_norm']}; {'deterministic algorithms' if dtype in DP_DETERMINISTIC else 'default mode'}); "
                f"{gaps(held)}; bars: each part's L2 {bars['state']}, a leaf "
                f"{FIT_LEAF_SHARE} of its largest value; launches a rank "
                f"{got['launches']}; ms a step, steps 2-{DP_STEPS} (the first), rank 0 "
                + "{:.3f} ({:.3f}), one process {:.3f} ({:.3f}); ".format(
                    *warm_ms(got["times"]), *warm_ms(ref["times"])) + smi_line)
            if not ok:
                raise AssertionError(f"[data parallel {dtype}] two ranks outside the bars: "
                                     f"{held}, {rel}")
            rec[dtype] = dict(rel=rel, held=held, rank_launches=got["launches"],
                              rank_ms=warm_ms(got["times"])[0],
                              one_ms=warm_ms(ref["times"])[0],
                              rank_first_ms=got["times"][0], one_first_ms=ref["times"][0])

        # --- fit in a world of one over NCCL ------------------------------------
        alphabet = [chr(c) for c in range(33, 33 + ModelConfig().nb_cls - 1)]
        datasets = tuple(LineSet(n, alphabet, SEED + 102 + i)
                         for i, n in enumerate(FIT_LINES))
        with socket.socket() as sock:
            sock.bind(("", 0))
            port = sock.getsockname()[1]
        keys = {mesh.COORDINATOR: f"localhost:{port}", mesh.NUM_PROCESSES: "1",
                mesh.PROCESS_ID: "0"}
        saved = {k: os.environ.get(k) for k in keys}
        os.environ.update(keys)
        try:
            reset_counts()
            result, losses = _recorded_fit(_fit_cfg(tmp, "nccl", DP_FIT_STEPS), datasets,
                                           device)
            fit_launches = read_counts()
            backend = torch.distributed.get_backend()
            t = torch.full((4,), 3.0, device=device)
            torch.distributed.all_reduce(t)
            torch.cuda.synchronize()
            if backend != "nccl" or not torch.equal(t.cpu(), torch.full((4,), 3.0)):
                raise AssertionError(f"[data parallel] backend {backend}, all-reduce {t}")
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        n_val = math.ceil(FIT_LINES[1] / BATCH)
        per_val = per_eval_launches(FULLY_FUSED)
        want = {k: DP_FIT_STEPS * per_step.get(k, 0) + n_val * per_val.get(k, 0)
                for k in COUNTERS}
        if fit_launches != want:
            raise AssertionError(f"[data parallel] fit launched {fit_launches}; expected {want}")
        say(f"[data parallel] fit over NCCL in a world of one: {DP_FIT_STEPS} steps and an "
            f"eval, pass-1 losses {losses}, best CER {result['best_cer']:.4f}; one "
            f"all-reduce of a device tensor on the NCCL group; launches {fit_launches}")
        launches = {k: launches[k] + fit_launches[k] for k in launches}
        rec["nccl_fit"] = dict(losses=losses, launches=fit_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"[data parallel] phase {time.perf_counter() - t_phase:.1f} s; {smi_line}")
    return launches, rec


def phase_multiwidth(device, smi_line):
    """``cli/train_multiwidth.py:run`` on in-memory lines at MW_WIDTHS, bs
    64, the flagship fully fused (augmentation off: no cv2 here): each
    step's launches held to ``lever_launches`` at its width, the eval of
    every bucket and the checkpoint; ms a step per width and the peak."""
    from htr_vt_torch.cli import train_multiwidth as mw
    t_phase = time.perf_counter()
    alphabet = [chr(c) for c in range(33, 33 + ModelConfig().nb_cls - 1)]
    buckets = [{"w": w, **{split: LineSet(n, alphabet, SEED + 120 + 2 * i + k, w,
                                          mw.len_range(w))
                           for k, (split, n) in enumerate((("train", MW_TRAIN_LINES),
                                                           ("val", MW_EVAL_LINES)))}}
               for i, w in enumerate(MW_WIDTHS)]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mw_", dir=root)
    iters = MW_STEPS_PER_WIDTH * len(MW_WIDTHS)
    args = mw.build_parser().parse_args([
        "--iters", str(iters), "--bs", str(WIDE_BATCH),
        "--widths", ",".join(str(w) for w in MW_WIDTHS),
        "--train-size", str(MW_TRAIN_LINES), "--eval-size", str(MW_EVAL_LINES),
        "--eval-every", str(iters), "--out", tmp])
    cfg = mw.base_config(args)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **FULLY_FUSED),
                              data=dataclasses.replace(cfg.data,
                                                       augment=AugmentConfig(enable=False)))
    depth = cfg.model.depth
    # K5 where a block's N = w / 4 tokens reach 256 (models/vit.py:resolve_attn_impl)
    want = {w: {**dict.fromkeys(COUNTERS, 0),
                **lever_launches("none", 1, flash=2 * depth if w // 4 >= 256 else 0)}
            for w in MW_WIDTHS}
    steps = []
    plain_step = mw.train_step

    def counted(state, batch):
        w = batch["image"].shape[2]
        before = read_counts()
        start, end = _events()
        start.record()
        m = plain_step(state, batch)
        end.record()
        end.synchronize()
        after = read_counts()
        got = {k: after[k] - before[k] for k in after}
        if got != want[w]:
            raise AssertionError(f"[multiwidth] a step at {w} px launched {got}; "
                                 f"expected {want[w]}")
        steps.append((w, start.elapsed_time(end), {k: v.item() for k, v in m.items()}))
        return m

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mw.train_step = counted
    reset_counts()
    try:
        summary = mw.run(buckets, cfg, args, device)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(tmp, "multiwidth_summary.json")) as f:
            written = json.load(f)
        saved = CheckpointManager(tmp).meta(os.path.join(tmp, "best_CER"))
    finally:
        mw.train_step = plain_step
        shutil.rmtree(tmp, ignore_errors=True)
    if [w for w, _, _ in steps] != [MW_WIDTHS[i % len(MW_WIDTHS)] for i in range(iters)]:
        raise AssertionError(f"[multiwidth] step widths {[w for w, _, _ in steps]}")
    if not all(math.isfinite(v) for _, _, m in steps for v in m.values()):
        raise AssertionError(f"[multiwidth] metrics {[m for _, _, m in steps]}")
    per_eval = per_eval_launches(FULLY_FUSED)
    n_eval = math.ceil(MW_EVAL_LINES / WIDE_BATCH)
    evals = {k: sum(n_eval * (per_eval.get(k, 0) + (
        depth if k == "flash_attention_fwd" and w // 4 >= 256 else 0)) for w in MW_WIDTHS)
        for k in COUNTERS}
    want_all = {k: sum(want[w][k] for w, _, _ in steps) + evals[k] for k in COUNTERS}
    if launches != want_all:
        raise AssertionError(f"[multiwidth] run launched {launches}; expected {want_all}")
    final = summary["final"]
    if written != summary or saved.get("widths") != list(MW_WIDTHS) or \
            saved.get("history") != summary["history"] or \
            not all(math.isfinite(final[str(w)]["cer"]) for w in MW_WIDTHS):
        raise AssertionError(f"[multiwidth] summary {summary}, checkpoint meta {saved}")
    rec = {"peak_mib": peak / 2**20, "launches": launches}
    for w in MW_WIDTHS:
        ms = [t for sw, t, _ in steps if sw == w]
        rec[w] = dict(ms=statistics.median(ms[1:]), first_ms=ms[0],
                      cer=final[str(w)]["cer"],
                      eval_ms_per_batch=final[str(w)]["eval_ms_per_batch"],
                      launches_a_step=want[w])
        say(f"[multiwidth {w}] {len(ms) - 1} steps after 1 warm-up: median "
            f"{rec[w]['ms']:.3f} ms/step ({WIDE_BATCH / rec[w]['ms'] * 1e3:.1f} img/s; "
            f"first {ms[0]:.3f}), launches a step {want[w]} (as predicted); eval "
            f"{final[str(w)]['eval_ms_per_batch']:.1f} ms a batch (host clock), CER "
            f"{final[str(w)]['cer']:.4f}")
    say(f"[multiwidth] train_multiwidth.run: {iters} steps over {list(MW_WIDTHS)} px, one "
        f"TrainState, bs {WIDE_BATCH}, fully fused, one eval a bucket and one checkpoint "
        f"(best_CER over the mean CER); losses "
        + " ".join(f"{m['loss']:.3f}" for _, _, m in steps)
        + f"; launches {launches}; peak memory {peak / 2**20:.1f} MiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {smi_line}")
    return launches, rec


def _tp_cfg(dtype, mesh_shape=None):
    return ExperimentConfig(model=ModelConfig(compute_dtype=dtype, masking=MaskConfig(
        mode="span", ratio=0.4, max_span_length=8), **FULLY_FUSED), optim=OptimConfig(),
        parallel=ParallelConfig(mesh_shape=mesh_shape))


def _tp_inputs(device):
    """The steps' batch and the validate's two batches (the second with 59
    valid rows) at TP_WIDTH px, and the codec."""
    rng = np.random.default_rng(SEED + 111)
    batch = wide_batch(WIDE_BATCH, TP_WIDTH, rng, device)
    alphabet = [chr(c) for c in range(33, 33 + ModelConfig().nb_cls - 1)]
    val = []
    for n_valid in (WIDE_BATCH, WIDE_BATCH - 5):
        b = wide_batch(WIDE_BATCH, TP_WIDTH, rng, device)
        labels, lengths = b["labels"].cpu().numpy(), b["label_lengths"].cpu().numpy()
        val.append((b, n_valid, ["".join(alphabet[c - 1] for c in row[:n])
                                 for row, n in zip(labels[:n_valid], lengths[:n_valid])]))
    return batch, val, CTCLabelConverter(alphabet)


def _tp_want(depth):
    """(launches a step, launches of the validate) at TP_WIDTH px: the
    fully fused step with K5 on every block, whatever the heads a rank
    holds."""
    step = {**dict.fromkeys(COUNTERS, 0), **lever_launches("none", 1, flash=2 * depth)}
    per_eval = per_eval_launches(FULLY_FUSED)
    val = {k: 2 * (per_eval.get(k, 0) + (depth if k == "flash_attention_fwd" else 0))
           for k in COUNTERS}
    return step, val


def _tp_run(dtype, mesh_shape, device):
    """TP_STEPS counted steps and one counted validate from the seeded state
    (deterministic algorithms for a dtype of DP_DETERMINISTIC): metrics,
    times, launches, the validate's (loss, CER, WER) and the state in the
    one-process layout on the host."""
    from htr_vt_torch.parallel import mesh
    batch, val, converter = _tp_inputs(device)
    state = create_train_state(_tp_cfg(dtype, mesh_shape), device,
                               torch.Generator(device=device).manual_seed(SEED + 110))
    want_step, want_val = _tp_want(state.cfg.model.depth)
    times, metrics = [], []
    with (deterministic_algorithms() if dtype in DP_DETERMINISTIC
          else contextlib.nullcontext()):
        for _ in range(TP_STEPS):
            before = read_counts()
            start, end = _events()
            start.record()
            m = train_step(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            after = read_counts()
            got = {k: after[k] - before[k] for k in after}
            if got != want_step:
                raise AssertionError(f"[tensor parallel {dtype}] a step at {mesh_shape} "
                                     f"launched {got}; expected {want_step}")
            metrics.append({k: v.item() for k, v in m.items()})
        reset_counts()
        result = validate(state.ema_model, val, converter)
        if read_counts() != want_val:
            raise AssertionError(f"[tensor parallel {dtype}] validate at {mesh_shape} "
                                 f"launched {read_counts()}; expected {want_val}")
    host = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    file = {"model": host(mesh.gather_state_dict(state.model)),
            "ema_model": host(mesh.gather_state_dict(state.ema_model)),
            "optimizer": {"state": {i: host(st) for i, st in mesh.gather_optimizer_state(
                state.model, state.optimizer)["state"].items()}},
            "step": state.step, "generator": state.generator.get_state()}
    heads = {m.num_heads // m.model_shards for m in state.model.modules()
             if hasattr(m, "num_heads") and hasattr(m, "model_shards")}
    del state
    torch.cuda.empty_cache()
    return {"metrics": metrics, "times": times, "val": result[:3], "state": file,
            "heads": sorted(heads), "launches": {k: TP_STEPS * want_step[k] + want_val[k]
                                                 for k in COUNTERS}}


def tp_worker(out_dir):
    """One rank of phase 24 (``python3 chip_smoke.py --tensor-parallel-rank
    DIR``, launched by ``phase_tensor_parallel`` with the ``HTRVT_*``
    variables): half of every block's heads and MLP units at
    ``mesh_shape=(1, TP_RANKS)``, over a gloo group that shares card 0 with
    the other rank, in each of DP_DTYPES."""
    from htr_vt_torch.parallel import mesh
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.maybe_initialize_distributed(backend="gloo")
    mesh.init_mesh((1, TP_RANKS))
    _build.library()
    out = {"world": mesh.world(), "data": mesh.data_world(), "model": mesh.model_world()}
    for dtype in DP_DTYPES:
        out[dtype] = _tp_run(dtype, (1, TP_RANKS), device)
    torch.save(out, os.path.join(out_dir, f"rank{out['world'][0]}.pt"))
    mesh.barrier()
    torch.distributed.destroy_process_group()


def phase_tensor_parallel(device, smi_line):
    """Two ranks on the one card over gloo at ``mesh_shape=(1, 2)``
    (``tp_worker``: 3 heads and half the MLP of every block each, the
    fully fused flagship at TP_WIDTH px, bs 64, bf16 and float32) against
    one process on the same weights, batch and masks, held at TP_BARS; the
    ranks' whole states equal; each rank's launches (K5 on 3 heads) and ms
    a step."""
    t_phase = time.perf_counter()
    rec = {}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=root)
    launches = dict.fromkeys(COUNTERS, 0)
    try:
        one = {}
        for dtype in DP_DTYPES:
            reset_counts()
            one[dtype] = _tp_run(dtype, None, device)
            launches = {k: launches[k] + one[dtype]["launches"][k] for k in COUNTERS}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ranks = run_ranks("--tensor-parallel-rank", tmp, TP_RANKS, TP_TIMEOUT,
                          "tensor parallel")
        if [(r["data"], r["model"]) for r in ranks] != [((0, 1), (m, TP_RANKS))
                                                         for m in range(TP_RANKS)]:
            raise AssertionError(f"[tensor parallel] grid {[r['model'] for r in ranks]}")
        for dtype in DP_DTYPES:
            got, ref, bars = ranks[0][dtype], one[dtype], TP_BARS[dtype]
            for r in ranks[1:]:
                same = r[dtype]["metrics"] == got["metrics"] and all(
                    torch.equal(v, r[dtype]["state"][part][k])
                    for part in ("model", "ema_model")
                    for k, v in got["state"][part].items())
                if not same:
                    raise AssertionError(f"[tensor parallel] {dtype}: the ranks' metrics "
                                         "or whole weights differ")
            heads = ModelConfig().num_heads
            if got["heads"] != [heads // TP_RANKS] or ref["heads"] != [heads]:
                raise AssertionError(f"[tensor parallel] heads a rank {got['heads']}, one "
                                     f"process {ref['heads']}")
            ok, rel, held = held_to_one(got, ref, bars)
            val_loss_rel = abs(got["val"][0] - ref["val"][0]) / abs(ref["val"][0])
            cer_gap = abs(got["val"][1] - ref["val"][1])
            ok = ok and val_loss_rel <= bars["loss"] and cer_gap <= TP_CER_GAP
            say(f"[tensor parallel {dtype}] {TP_RANKS} ranks on one card over gloo at "
                f"mesh (1, {TP_RANKS}), {got['heads'][0]} heads a rank, bs {WIDE_BATCH} at "
                f"{TP_WIDTH} px, {TP_STEPS} fully fused steps, against one process on the "
                "same weights, batch and masks: relative gaps a step "
                + "; ".join(f"{k} " + " ".join(f"{v:.3e}" for v in vs)
                            for k, vs in rel.items())
                + f" (bars: the first step's losses {bars['first_loss']} and grad_norm "
                f"{bars['first_grad_norm']}, every step's {bars['loss']} and "
                f"{bars['grad_norm']}; "
                f"{'deterministic algorithms' if dtype in DP_DETERMINISTIC else 'default mode'}"
                f"); {gaps(held)}; bars: each part's L2 {bars['state']}, a leaf "
                f"{FIT_LEAF_SHARE} of its largest value; validate loss {got['val'][0]:.5f} "
                f"(one process {ref['val'][0]:.5f}, {val_loss_rel:.3e} rel), CER "
                f"{got['val'][1]:.4f} ({ref['val'][1]:.4f}); launches a rank "
                f"{got['launches']}; ms a step, steps 2-{TP_STEPS} (the first), rank 0 "
                + "{:.3f} ({:.3f}), one process {:.3f} ({:.3f}); ".format(
                    *warm_ms(got["times"]), *warm_ms(ref["times"])) + smi_line)
            if not ok:
                raise AssertionError(f"[tensor parallel {dtype}] two ranks outside the "
                                     f"bars: {held}, {rel}, validate {got['val']} "
                                     f"{ref['val']}")
            rec[dtype] = dict(rel=rel, held=held, val=got["val"], one_val=ref["val"],
                              rank_launches=got["launches"],
                              rank_ms=warm_ms(got["times"])[0],
                              one_ms=warm_ms(ref["times"])[0],
                              rank_first_ms=got["times"][0], one_first_ms=ref["times"][0])
            launches = {k: launches[k] + got["launches"][k] for k in COUNTERS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"[tensor parallel] phase {time.perf_counter() - t_phase:.1f} s; {smi_line}")
    return launches, rec


def _tpz_cfg(name, dtype, mesh_shape, vocab_size):
    """The phase-25 configuration of ``name`` (``sgm``, ``ed``, ``int8`` or a
    TPZ_ZOO encoder) in ``dtype`` at ``mesh_shape``; ``vocab_size`` is the SGM
    head's or the encoder-decoder's."""
    par = ParallelConfig(mesh_shape=mesh_shape)
    masking = MaskConfig(mode="span", ratio=0.4, max_span_length=8)
    train = TrainConfig()
    if name == "sgm":
        model = apply_variant_preset(ModelConfig(
            encoder="conformer", compute_dtype=dtype,
            masking=MaskConfig(mode="mms", max_span_length=8),
            sgm=SGMConfig(enable=True, vocab_size=vocab_size, sub_len=SGM_SUB_LEN),
            **FULLY_FUSED))
        train = TrainConfig(tri_masked=True)
    elif name == "ed":
        model = ModelConfig(model_type="encoder_decoder", decoder_layers=6, decoder_heads=8,
                            max_seq_len=256, ed_vocab_size=vocab_size, compute_dtype=dtype,
                            masking=masking, **FULLY_FUSED)
    elif name == "int8":
        model = ModelConfig(quant="int8")
    else:
        model = apply_variant_preset(ModelConfig(encoder=name, compute_dtype=dtype,
                                                 masking=masking, **FULLY_FUSED))
    return ExperimentConfig(model=model, optim=OptimConfig(), train=train, parallel=par)


def _tpz_inputs(device):
    """The phase's batches: the SGM lines at TPZ_SGM_WIDTH, the zoo's and the
    int8 lines at TPZ_WIDTH, the encoder-decoder's lines with their
    teacher-forcing arrays; the SGM vocabulary and the ED tokenizer."""
    alphabet = [chr(c) for c in range(33, 33 + 79)]
    vocab = SGMVocab(CTCLabelConverter(alphabet))
    tokenizer = EDTokenizer.from_ctc_converter(CTCLabelConverter(sorted(alphabet)))
    rng = np.random.default_rng(SEED + 120)
    sgm = sgm_batch(TPZ_BATCH, TPZ_SGM_WIDTH, WIDE_LMAX[TPZ_SGM_WIDTH], vocab, rng, device)
    zoo = zoo_batch(TPZ_BATCH, TPZ_WIDTH, rng, device)
    texts = ["".join(rng.choice(alphabet, m)) for m in rng.integers(1, TPZ_ED_LMAX + 1,
                                                                   TPZ_BATCH)]
    tin, tout, tlen = tokenizer.encode_for_training(texts, TPZ_ED_LMAX + 2)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    ed = {"image": put(line_images(TPZ_BATCH, rng, TPZ_WIDTH)),
          "labels": torch.zeros((TPZ_BATCH, 4), dtype=torch.int32, device=device),
          "label_lengths": torch.zeros(TPZ_BATCH, dtype=torch.int32, device=device),
          "ed_input": put(tin), "ed_output": put(tout), "ed_lengths": put(tlen)}
    calib = put(line_images(TPZ_BATCH, rng, TPZ_WIDTH))
    return dict(sgm=sgm, zoo=zoo, ed=ed, calib=calib, vocab=vocab, tokenizer=tokenizer)


def _tpz_state_file(state):
    """A state in the one-process layout on the host (gathered over the
    model group where sharded)."""
    from htr_vt_torch.parallel import mesh
    host = lambda sd: {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}  # noqa: E731
    return {"model": host(mesh.gather_state_dict(state.model)),
            "ema_model": host(mesh.gather_state_dict(state.ema_model)),
            "optimizer": {"state": {i: host(st) for i, st in mesh.gather_optimizer_state(
                state.model, state.optimizer)["state"].items()}},
            "step": state.step, "generator": state.generator.get_state()}


def _tpz_counted(fn):
    """(fn's result, its launches, its CUDA-event ms)."""
    torch.cuda.synchronize()
    reset_counts()
    start, end = _events()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, read_counts(), start.elapsed_time(end)


def _tpz_run(mesh_shape, device):
    """Every model of phase 25 at ``mesh_shape`` (None: one process), from
    the same seeds: metrics, the state after its step, the eval logits and
    loss, the generated ids, launches and ms of each call, the attention
    shapes K5 saw."""
    from htr_vt_torch.models import vit
    inputs = _tpz_inputs(device)
    seen = []
    flash = vit.flash_attention

    def recording(q, k, v, scale):
        seen.append(tuple(q.shape))
        return flash(q, k, v, scale)

    vit.flash_attention = recording
    out = {}
    try:
        for name, dtypes in (("sgm", DP_DTYPES), *((n, ("bfloat16",)) for n in TPZ_ZOO),
                             ("ed", ("bfloat16",))):
            batch = inputs["ed" if name == "ed" else "sgm" if name == "sgm" else "zoo"]
            vocab_size = (inputs["tokenizer"].vocab_size if name == "ed"
                          else inputs["vocab"].size)
            for dtype in dtypes:
                cfg = _tpz_cfg(name, dtype, mesh_shape, vocab_size)
                state = create_train_state(cfg, device, torch.Generator(
                    device=device).manual_seed(SEED + 121))
                rec = {}
                seen.clear()
                with (deterministic_algorithms() if dtype in DP_DETERMINISTIC
                      else contextlib.nullcontext()):
                    m, rec["step_launches"], rec["first_step_ms"] = _tpz_counted(
                        lambda: train_step(state, batch))
                rec["metrics"] = [{k: v.item() for k, v in m.items()}]
                rec["step_k5"] = sorted(set(seen))
                rec["state"] = _tpz_state_file(state)
                warm = []  # the same calls again, warm: their ms, launches counted apart
                if name == "ed":
                    image = batch["image"]
                    for method in ("greedy", "beam_search"):
                        def gen(method=method):
                            return generate(state.model, image, method=method,
                                            max_len=TPZ_ED_LEN, beam_size=ED_BEAM)
                        ids, rec[f"{method}_launches"], _ = _tpz_counted(gen)
                        rec[method] = ids.cpu()
                        warm.append((f"{method}_ms", gen))
                else:
                    seen.clear()
                    ev, rec["eval_launches"], _ = _tpz_counted(
                        lambda: eval_step(state.model, batch))
                    rec["eval_k5"] = sorted(set(seen))
                    rec["logits"] = ev["logits"].float().cpu()
                    rec["eval_loss"] = ev["loss"].item()
                    warm.append(("eval_ms", lambda: eval_step(state.model, batch)))
                warm.append(("step_ms", lambda: train_step(state, batch)))
                rec["warm_launches"] = dict.fromkeys(COUNTERS, 0)
                with (deterministic_algorithms() if dtype in DP_DETERMINISTIC
                      else contextlib.nullcontext()):
                    for key, fn in warm:
                        _, counts, rec[key] = _tpz_counted(fn)
                        rec["warm_launches"] = {c: rec["warm_launches"][c] + counts[c]
                                                for c in COUNTERS}
                rec["heads"] = sorted({m.num_heads // m.model_shards
                                       for m in state.model.modules()
                                       if hasattr(type(m), "model_shards")
                                       and hasattr(m, "num_heads")})
                out[name if len(dtypes) == 1 else f"{name}_{dtype}"] = rec
                del state
                torch.cuda.empty_cache()
        # int8 serving: the vit flagship's seeded weights (stage 1 padded),
        # calibrated on one batch
        cfg8 = _tpz_cfg("int8", "bfloat16", mesh_shape, 0).model
        model = build_model(cfg8, device=device)
        model.load_state_dict(q8.serving_arrays(cfg8, _tpz_int8_weights(device)))
        if mesh_shape is not None:
            from htr_vt_torch.parallel import mesh
            mesh.shard_model(model)
        stats = q8.calibrate_quant_stats(model, [inputs["calib"]], 1)
        ev, launches, _ = _tpz_counted(lambda: eval_step(model, inputs["zoo"]))
        _, warm, ms = _tpz_counted(lambda: eval_step(model, inputs["zoo"]))
        out["int8"] = dict(logits=ev["logits"].float().cpu(), eval_launches=launches,
                           eval_ms=ms, warm_launches=warm,
                           stats={k: v.item() for k, v in stats.items()})
        del model
        torch.cuda.empty_cache()
    finally:
        vit.flash_attention = flash
    return out


def _tpz_int8_weights(device, dtype="bfloat16"):
    """The seeded float flagship's state_dict (phase 25's int8 weights)."""
    return build_model(ModelConfig(compute_dtype=dtype), device=device,
                       generator=torch.Generator(device=device).manual_seed(
                           SEED + 122)).state_dict()


def tpz_worker(out_dir):
    """One rank of phase 25 (``python3 chip_smoke.py
    --tensor-parallel-zoo-rank DIR``, launched by
    ``phase_tensor_parallel_zoo`` with the ``HTRVT_*`` variables): every
    model of the phase at ``mesh_shape=(1, TP_RANKS)`` over a gloo group
    that shares card 0 with the other rank."""
    from htr_vt_torch.parallel import mesh
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.maybe_initialize_distributed(backend="gloo")
    mesh.init_mesh((1, TP_RANKS))
    _build.library()
    out = {"world": mesh.world(), "model": mesh.model_world(),
           "runs": _tpz_run((1, TP_RANKS), device)}
    torch.save(out, os.path.join(out_dir, f"rank{out['world'][0]}.pt"))
    mesh.barrier()
    torch.distributed.destroy_process_group()


def _tpz_want(name, depth):
    """(launches of the step, of the eval or of each generation) of one
    process, as the earlier phases count them."""
    zero = dict.fromkeys(COUNTERS, 0)
    if name == "sgm":
        k5 = depth * TRI_FORWARDS * 2
        return ({**zero, **per_step_launches(FULLY_FUSED, TRI_FORWARDS),
                 "flash_attention_fwd": k5, "flash_attention_bwd_dkv": k5,
                 "flash_attention_bwd_dq": k5},
                {**zero, **per_eval_launches(FULLY_FUSED), "flash_attention_fwd": depth})
    if name in ("swin", "svtr"):  # the switches reach none of their stems
        return {**zero, **per_step_launches({})}, {**zero, **per_eval_launches({})}
    if name == "ed":  # no CTC; the trunk's stem once a generation
        step = {k: v for k, v in per_step_launches(FULLY_FUSED).items()
                if not k.startswith("ctc")}
        gen = {k: v for k, v in per_eval_launches(FULLY_FUSED).items()
               if not k.startswith("ctc")}
        return {**zero, **step}, {**zero, **gen}
    return ({**zero, **per_step_launches(FULLY_FUSED)},
            {**zero, **per_eval_launches(FULLY_FUSED)})


def _ed_first_flip(model, model32, image, ids, got, method):
    """The generated ``got`` against one process's ``ids``: (the first
    position where they differ or None, whether the float32 top-2 margin
    there is at least twice the bf16 model's largest logit error, that
    error). One process's ids are teacher-forced through its bf16 model and
    a float32 copy; greedy reads the margin after the repetition penalty it
    applied, beam search of the log-probabilities."""
    from htr_vt_torch.models.encoder_decoder import apply_repetition_penalty
    sos = 1
    tin = torch.cat([torch.full_like(ids[:, :1], sos), ids[:, :-1]], dim=1).to(image.device)
    with torch.inference_mode():
        l16 = model.decode_logits(model.encode(image), tin).float()
        l32 = model32.decode_logits(model32.encode(image), tin)
        noise = (l16 - l32).abs().max().item()
        if method == "beam_search":
            l32 = F.log_softmax(l32, dim=-1)
        else:
            buf = torch.zeros(ids.shape[0], ids.shape[1] + 1, dtype=torch.long,
                              device=image.device)
            buf[:, 0] = sos
            for t in range(ids.shape[1]):
                l32[:, t] = apply_repetition_penalty(l32[:, t], buf, 1.3)
                buf[:, t + 1] = ids[:, t].to(image.device)
        top2 = l32.topk(2, dim=-1).values
    decidable = ((top2[..., 0] - top2[..., 1]) >= 2 * noise).cpu()
    diff = (got != ids)
    rows = diff.any(1)
    if not rows.any():
        return None, True, noise
    first = diff.float().argmax(1)
    held = all(not decidable[r, first[r]] for r in torch.nonzero(rows)[:, 0].tolist())
    return int(first[rows].min()), held, noise


def phase_tensor_parallel_zoo(device, smi_line):
    """Two ranks on the one card over gloo at ``mesh_shape=(1, 2)``
    (``tpz_worker``) against one process on the same weights, batch and
    masks: the tri-masked SGM conformer at 1024 px (bf16 and float32), the
    TPZ_ZOO models, the encoder-decoder and the int8 vit, at TP_BARS and
    the phase's floors; every rank's launches equal to one process's, K5
    at a rank's 3 heads; the ranks' states equal; ms a call."""
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tpz_", dir=root)
    tag = "tensor parallel zoo"
    rec = {}
    try:
        one = _tpz_run(None, device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t_ranks = time.perf_counter()
        ranks = run_ranks("--tensor-parallel-zoo-rank", tmp, TP_RANKS, TP_TIMEOUT, tag)
        rec["ranks_s"] = time.perf_counter() - t_ranks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if [r["model"] for r in ranks] != [(m, TP_RANKS) for m in range(TP_RANKS)]:
        raise AssertionError(f"[{tag}] grid {[r['model'] for r in ranks]}")
    got_all = [r["runs"] for r in ranks]
    launches = dict.fromkeys(COUNTERS, 0)
    depth = {n: _tpz_cfg(n, "bfloat16", None, 83).model.depth
             for n in ("sgm", "ed", *TPZ_ZOO)}
    failures = []
    for key, ref in one.items():
        got = got_all[0][key]
        name = key.split("_")[0] if key.startswith("sgm") else key
        dtype = key.split("_")[1] if key.startswith("sgm") else "bfloat16"
        bars = TP_BARS[dtype]
        calls = [k for k in ("step", "eval", "greedy", "beam_search")
                 if f"{k}_launches" in ref]
        for k in calls:  # every rank's launches are one process's
            for r in got_all:
                if r[key][f"{k}_launches"] != ref[f"{k}_launches"]:
                    failures.append(f"{key} {k}: a rank launched {r[key][k + '_launches']}, "
                                    f"one process {ref[k + '_launches']}")
            launches = {c: launches[c] + TP_RANKS * got[f"{k}_launches"][c] +
                        ref[f"{k}_launches"][c] for c in COUNTERS}
        launches = {c: launches[c] + sum(r[key]["warm_launches"][c] for r in got_all)
                    + ref["warm_launches"][c] for c in COUNTERS}
        if name != "int8":
            want_step, want_eval = _tpz_want(name, depth[name])
            for k in calls:
                if ref[f"{k}_launches"] != (want_step if k == "step" else want_eval):
                    failures.append(f"{key} {k}: one process launched "
                                    f"{ref[k + '_launches']}, expected "
                                    f"{want_step if k == 'step' else want_eval}")
            for r in got_all[1:]:
                same = r[key]["metrics"] == got["metrics"] and all(
                    torch.equal(v, r[key]["state"][part][k])
                    for part in ("model", "ema_model") for k, v in got["state"][part].items())
                if not same:
                    failures.append(f"{key}: the ranks' metrics or whole weights differ")
            ok, rel, held = held_to_one(got, ref, bars)
            line = (f"[{tag} {key}] heads a rank {got['heads']} (one process "
                    f"{ref['heads']}); one SAM step at bs {TPZ_BATCH}: relative gaps "
                    + "; ".join(f"{k} {v[0]:.3e}" for k, v in rel.items())
                    + f" (bars {bars['first_loss']} / {bars['first_grad_norm']}); "
                    f"{gaps(held)}; ms a step (a second, warm step), rank 0 "
                    f"{got['step_ms']:.3f}, one process {ref['step_ms']:.3f} (the compared "
                    f"first step {got['first_step_ms']:.3f} / {ref['first_step_ms']:.3f})")
            if not ok:
                failures.append(f"{key}: outside {bars}: {rel}, {held}")
        if name == "sgm":
            want_k5 = [TPZ_K5_SHAPE]
            if got["step_k5"] != want_k5 or got["eval_k5"] != want_k5:
                failures.append(f"{key}: K5 ran at {got['step_k5']} / {got['eval_k5']}, "
                                f"expected {want_k5}")
            line += f"; K5 a rank at {got['step_k5']}, one process at {ref['step_k5']}"
        if "logits" in ref and name != "int8":
            eval_rel = abs(got["eval_loss"] - ref["eval_loss"]) / abs(ref["eval_loss"])
            dmax = (got["logits"] - ref["logits"]).abs().max().item()
            agree = (got["logits"].argmax(-1) == ref["logits"].argmax(-1)).float().mean()
            line += (f"; eval_step loss {eval_rel:.3e} rel, max |dlogits| {dmax:.4f}, frame "
                     f"argmax agreement {agree.item():.4%}, ms rank 0 {got['eval_ms']:.3f}, "
                     f"one process {ref['eval_ms']:.3f}")
            if eval_rel > bars["loss"]:
                failures.append(f"{key}: eval loss {eval_rel:.3e} rel")
        if name == "ed":
            cfg32 = _tpz_cfg("ed", "float32", None, ref["state"]["model"]["embed.weight"]
                             .shape[0]).model
            m16 = build_model(_tpz_cfg("ed", "bfloat16", None, cfg32.ed_vocab_size).model,
                              device=device)
            m32 = build_model(cfg32, device=device)
            for m in (m16, m32):
                m.load_state_dict({k: v.to(device) for k, v in ref["state"]["model"].items()})
            image = _tpz_inputs(device)["ed"]["image"]
            for method in ("greedy", "beam_search"):
                first, ok_ids, noise = _ed_first_flip(m16, m32, image, ref[method],
                                                      got[method], method)
                line += (f"; {method} ids: first difference "
                         f"{'none' if first is None else f'at position {first}'}"
                         f" (bf16 logit error {noise:.4f}), ms rank 0 "
                         f"{got[method + '_ms']:.1f}, one process {ref[method + '_ms']:.1f}")
                if not ok_ids:
                    failures.append(f"ed {method}: ids differ where the float32 margin is "
                                    f"at least twice the bf16 error")
            del m16, m32
            torch.cuda.empty_cache()
        if name == "int8":
            diff = (got["logits"] - ref["logits"]).abs().max().item()
            stats_off = sorted(k for k, v in ref["stats"].items() if got["stats"][k] != v)
            m32 = build_model(ModelConfig(compute_dtype="float32"), device=device)
            m32.load_state_dict(_tpz_int8_weights(device))
            l32 = eval_step(m32, _tpz_inputs(device)["zoo"])["logits"].float().cpu()
            own = float((ref["logits"] - l32).norm() / l32.norm())
            tp = float((got["logits"] - ref["logits"]).norm() / ref["logits"].norm())
            line = (f"[{tag} int8] vit at {TPZ_WIDTH} px, calibrated on one batch: logits "
                    f"{'bit-equal to' if diff == 0 else f'{diff:.4f} max |d| from'} one "
                    f"process ({tp:.3e} relative L2; int8 against float32 {own:.3e})"
                    + ("" if diff == 0 else
                       f"; statistics that differ: {stats_off[:4] or 'none'} (the float "
                       "products around the int8 sites: the column sites' GEMMs over half "
                       "the output columns and the attention over half the heads)")
                    + f"; ms rank 0 {got['eval_ms']:.3f}, one process {ref['eval_ms']:.3f}")
            if tp > own or not all(torch.equal(got["logits"], r["int8"]["logits"])
                                   for r in got_all):
                failures.append(f"int8: {tp:.3e} from one process (int8 itself {own:.3e}), "
                                "or the ranks differ")
            rec["int8"] = dict(max_dlogits=diff, rel=tp, int8_rel=own, stats_off=stats_off,
                               rank_ms=got["eval_ms"], one_ms=ref["eval_ms"])
            del m32
        else:
            rec[key] = dict(rel=rel, held=held, rank_launches=got["step_launches"],
                            rank_ms=got["step_ms"], one_ms=ref["step_ms"])
        say(line + f"; {smi_line}")
    rec["phase_s"] = time.perf_counter() - t_phase
    say(f"[{tag}] phase {rec['phase_s']:.1f} s (ranks {rec['ranks_s']:.1f} s); "
        f"launches {launches}; {smi_line}")
    if failures:
        raise AssertionError(f"[{tag}] " + "; ".join(failures))
    return launches, rec


def _wp_cfg(switches, dtype, **model_kw):
    return ExperimentConfig(model=ModelConfig(compute_dtype=dtype, masking=MaskConfig(
        mode="span", ratio=0.4, max_span_length=8), **WP_SWITCHES[switches], **model_kw),
        optim=OptimConfig())


def _wp_zoo_cfg(name):
    """A WP_ZOO model's recipe at its preset, bf16, the phase's span masking
    (the switches reach none of these stems)."""
    return ExperimentConfig(model=apply_variant_preset(ModelConfig(
        encoder=name, compute_dtype="bfloat16", masking=MaskConfig(
            mode="span", ratio=0.4, max_span_length=8))), optim=OptimConfig())


def _wp_inputs(device):
    """The steps' batch and the eval probe at WP_WIDTH px, and the WP_WIDE-px
    batch, bs WIDE_BATCH."""
    rng = np.random.default_rng(SEED + 121)
    return (train_batch(WIDE_BATCH, ModelConfig(), rng, device),
            train_batch(WIDE_BATCH, ModelConfig(), rng, device),
            wide_batch(WIDE_BATCH, WP_WIDE, rng, device))


def _wp_run(cfg, width_parallel, device, batch, probe=None, steps=WP_STEPS, warm=0):
    """From the seeded state of ``cfg`` (width-sharded with
    ``width_parallel``, each call taking this rank's strip of the batch): a
    counted ``eval_step`` of ``probe`` and a second, warm one timed; then
    ``steps`` counted SAM steps, the compared ones (deterministic algorithms
    for a dtype of DP_DETERMINISTIC), the state taken after them, and
    ``warm`` more, timed and counted. Metrics of the compared steps,
    CUDA-event ms and launches of every step, the steps' peak memory (MiB,
    this process), the state on the host."""
    from htr_vt_torch.parallel import mesh
    dtype = cfg.model.compute_dtype
    state = create_train_state(cfg, device,
                               torch.Generator(device=device).manual_seed(SEED + 120),
                               tensor_parallel=False, width_parallel=width_parallel)
    cut = mesh.rank_width if width_parallel else (lambda b: b)
    rec = {}
    if probe is not None:
        reset_counts()
        out = eval_step(state.model, cut(probe))
        rec["eval"] = {"logits": out["logits"].float().cpu(), "loss": out["loss"].item(),
                       "launches": read_counts()}
        _, rec["eval"]["warm_launches"], rec["eval"]["ms"] = _tpz_counted(
            lambda: eval_step(state.model, cut(probe)))
    mine = cut(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, metrics, launches = [], [], []
    with (deterministic_algorithms() if dtype in DP_DETERMINISTIC
          else contextlib.nullcontext()):
        for i in range(steps + warm):
            if i == steps:
                rec["state"] = _dp_state_file(state)
            reset_counts()
            start, end = _events()
            start.record()
            m = train_step(state, mine)
            end.record()
            end.synchronize()
            launches.append(read_counts())
            times.append(start.elapsed_time(end))
            if i < steps:
                metrics.append({k: v.item() for k, v in m.items()})
    rec.update(metrics=metrics, times=times, launches=launches,
               peak_mib=torch.cuda.max_memory_allocated() / 2**20,
               noise_leaves=zero_gradient_leaves(state.model))
    rec.setdefault("state", _dp_state_file(state))
    del state, mine
    torch.cuda.empty_cache()
    return rec


def _wp_int8(width_parallel, device):
    """The int8 flagship of each WP_INT8_FORMS form on phase 25's seeded
    float weights (stage 1 padded), width-sharded with ``width_parallel``:
    calibrated on one batch of this rank's strips, then a counted static
    ``eval_step`` and a warm, timed one; one process adds the float32
    logits of the same weights."""
    from htr_vt_torch.parallel import mesh
    rng = np.random.default_rng(SEED + 124)
    batch = zoo_batch(TPZ_BATCH, WP_WIDTH, rng, device)
    calib = torch.from_numpy(line_images(TPZ_BATCH, rng, WP_WIDTH)).to(device)
    cut = mesh.rank_width if width_parallel else (lambda b: b)
    sd = _tpz_int8_weights(device)
    out = {}
    for form, kw in WP_INT8_FORMS.items():
        cfg8 = ModelConfig(quant="int8", **kw)
        model = build_model(cfg8, device=device)
        model.load_state_dict(q8.serving_arrays(cfg8, sd))
        if width_parallel:
            mesh.shard_width(model)
        stats = q8.calibrate_quant_stats(model, [cut({"image": calib})["image"]], 1)
        ev, launches, _ = _tpz_counted(lambda: eval_step(model, cut(batch)))
        _, warm, ms = _tpz_counted(lambda: eval_step(model, cut(batch)))
        out[form] = dict(logits=ev["logits"].float().cpu(), launches=launches,
                         warm_launches=warm, eval_ms=ms,
                         stats={k: v.item() for k, v in stats.items()})
        del model
        torch.cuda.empty_cache()
    if not width_parallel:
        m32 = build_model(ModelConfig(compute_dtype="float32"), device=device)
        m32.load_state_dict(sd)
        out["float32"] = eval_step(m32, batch)["logits"].float().cpu()
        del m32
        torch.cuda.empty_cache()
    return out


def _wp_all(width_parallel, device):
    """Every run of phase 26 in one process or one rank."""
    batch, probe, wide = _wp_inputs(device)
    out = {run: _wp_run(_wp_cfg(*run), width_parallel, device, batch,
                        probe if i == 0 else None)
           for i, run in enumerate(WP_RUNS)}
    out["wide"] = _wp_run(_wp_cfg("fully_fused", "bfloat16"), width_parallel, device, wide,
                          steps=1, warm=1)
    out["wide_remat"] = _wp_run(_wp_cfg("fully_fused", "bfloat16", remat="all"),
                                width_parallel, device, wide, steps=1, warm=1)
    del wide
    zoo = zoo_batch(TPZ_BATCH, WP_WIDTH, np.random.default_rng(SEED + 123), device)
    for name in WP_ZOO:
        out[name] = _wp_run(_wp_zoo_cfg(name), width_parallel, device, zoo, probe=zoo,
                            steps=1, warm=1)
    out.update(_wp_int8(width_parallel, device))
    return out


def wp_worker(out_dir):
    """One rank of phase 26 (``python3 chip_smoke.py --width-parallel-rank
    DIR``, launched by ``phase_width_parallel`` with the ``HTRVT_*``
    variables): its strip of every image's columns at ``mesh_shape=(1,
    WP_RANKS)``, over a gloo group that shares card 0 with the other rank."""
    from htr_vt_torch.parallel import mesh
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.maybe_initialize_distributed(backend="gloo")
    mesh.init_mesh((1, WP_RANKS))
    _build.library()
    out = {"world": mesh.world(), "data": mesh.data_world(), "model": mesh.model_world(),
           **_wp_all(True, device)}
    torch.save(out, os.path.join(out_dir, f"rank{out['world'][0]}.pt"))
    mesh.barrier()
    torch.distributed.destroy_process_group()


def _wp_strip_kernels(device):
    """K3f and K4f on a rank's halo-extended strip of the flagship at
    WP_WIDTH px, bs WIDE_BATCH (W / WP_RANKS columns and one neighbour
    column, made channels-last from a ``torch.cat`` as ``halo_extend``
    makes it) against their plain versions: K3f bit for bit, K4f (stage 1,
    with the prologue) at ``_held``'s bar; the device ms of each and of its
    plain version."""
    w = WP_WIDTH // WP_RANKS
    rec = {}
    c = ModelConfig().embed_dim // 4
    for name, shape in (("pool_bn_relu_fwd", (WIDE_BATCH, c, 32, w)),
                        ("conv3x3_bn_relu_fwd", (WIDE_BATCH, c, 8, w))):
        x = stem_input(shape[:3] + (w + 1,), device, seed=w)
        ext = torch.cat([x[..., :1], x[..., 1:]], dim=-1)
        ext = ext.contiguous(memory_format=torch.channels_last)
        gen = torch.Generator(device=device).manual_seed(w + 1)
        scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=device)
        shift = 0.2 * torch.randn(c, generator=gen, device=device)
        if name == "pool_bn_relu_fwd":
            kernel = lambda: pool_fused.pool_bn_relu_fwd(ext, scale, shift)  # noqa: E731
            plain = lambda: pool_fused.max_pool_bn_relu_reference(  # noqa: E731
                ext, scale, shift)
            y, want = kernel(), plain()
            if not torch.equal(y, want):
                raise AssertionError("[width parallel] K3f on a halo-extended strip "
                                     "differs from its plain version")
            err = (y.float() - want.float()).abs().max().item()
        else:
            k = (torch.randn((c, c, 3, 3), generator=gen, device=device)
                 * math.sqrt(2.0 / (9 * c))).to(torch.bfloat16)
            kernel = lambda: conv_fused.conv3x3_bn_relu_fwd(  # noqa: E731
                ext, k, scale, shift)
            plain = lambda: conv_fused.conv3x3_bn_relu_reference(  # noqa: E731
                ext, k, scale, shift)
            mag = F.conv2d(conv_fused._prologue(ext, scale, shift).float().abs(),
                           k.float().abs(), padding=1)
            err, _ = _held("[width parallel] K4f on a halo-extended strip", kernel(),
                           plain(), mag, BF16_ULP_REL)
            del mag
        rec[name] = {"shape": list(ext.shape), "max_abs_err": err,
                     "ms": device_ms(f"{name} strip", [kernel]),
                     "plain_ms": device_ms(f"{name} strip plain", [plain])}
        say(f"[width parallel] {name} on a halo-extended strip {list(ext.shape)} bf16: "
            f"{rec[name]['ms']:.4f} ms a launch (plain {rec[name]['plain_ms']:.4f}), max "
            f"|err| {err:.3e}")
        del x, ext
    # Q1 on a rank's strip of the int8 stem (stage 1 padded to 256): stage 1's
    # conv2 (bf16 in, its BN prologue applied by Q1 before its padding) on the
    # strip and a neighbour column; stage 2's entry conv1 (W-stride 2) on the
    # s8 carry with its left column and zero rows (models/stem.py:
    # _left_column), padding 0
    for name, shape, cout, stride, padding, kind in (
            ("conv_int8", (WIDE_BATCH, 256, 8, w + 1), 256, (1, 1), 1, "bf16+bn"),
            ("conv_int8_left_column", (WIDE_BATCH, 256, 10, w + 1), 384, (2, 2), 0, "s8")):
        inp, wq, w_packed, sw, sx = q1_site_inputs(shape, cout, 3, kind, device,
                                                   SEED + 125)
        src = inp["xq"] if kind == "s8" else inp["x"]
        if padding == 0:
            src[:, :, [0, -1]] = 0
        src = torch.cat([src[..., :1], src[..., 1:]], dim=-1).contiguous(
            memory_format=torch.channels_last)
        x, xq = (None, src) if kind == "s8" else (src, None)
        dq = sx * sw

        def kernel():
            return q8.conv_int8_cuda(x, w_packed, sx, dq, stride, padding, torch.bfloat16,
                                     xq=xq, prologue=inp["prologue"])

        def plain():
            return q8.conv_int8_reference(x, wq, sx, dq, stride, padding, torch.bfloat16,
                                          xq=xq, prologue=inp["prologue"])

        with torch.inference_mode():
            y, want = kernel(), plain()
            if not torch.equal(y, want):
                raise AssertionError(f"[width parallel] Q1 ({name}) on a rank's strip "
                                     "differs from its plain version")
            rec[name] = {"shape": list(src.shape), "cout": cout, "stride": list(stride),
                         "padding": padding, "input": kind,
                         "max_abs_err": (y.float() - want.float()).abs().max().item(),
                         "ms": device_ms(f"{name} strip", [kernel]),
                         "plain_ms": median_ms(plain, 1, warmup=0)}
        say(f"[width parallel] Q1 {name} on a rank's strip {list(src.shape)} {kind} -> "
            f"{cout}, 3x3/{tuple(stride)}, padding {padding}: bit-equal to its plain "
            f"version; {rec[name]['ms']:.4f} ms a launch (plain, float64, one call "
            f"{rec[name]['plain_ms']:.2f})")
        del inp, src, x, xq, y, want
    torch.cuda.empty_cache()
    return rec


def int8_eval_launches(switches, depth):
    """Launches of a static int8 ``eval_step`` of the flagship (stage 1
    padded): Q1 at its 15 sites, ``_int_mm`` at the blocks' 4 linears, the
    CTC alpha kernel, and K3f with ``pool_impl="pallas"``."""
    return {"ctc_alpha": 1, "conv_int8": sum(site[-1] for site in INT8_SITES),
            "int_mm": 4 * depth,
            **({"pool_bn_relu_fwd": 1} if switches.get("pool_impl") == "pallas" else {})}


def _wp_held_int8(form, got, ref, l32, ranks):
    """A rank's int8 logits against one process's: (bit-equal, relative L2,
    int8 against float32's relative L2, the decidable frames' argmax
    agreement, the largest gap), failing past phase 25's int8 reading."""
    diff = (got["logits"] - ref["logits"]).abs().max().item()
    rel = float((got["logits"] - ref["logits"]).norm() / ref["logits"].norm())
    own = float((ref["logits"] - l32).norm() / l32.norm())
    top2 = ref["logits"].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * diff
    agree = (got["logits"].argmax(-1)[clear] == ref["logits"].argmax(-1)[clear]).float()
    agree = agree.mean().item() if clear.any() else 1.0
    if rel > own or agree < 1.0 or not all(
            torch.equal(got["logits"], r[form]["logits"]) for r in ranks):
        raise AssertionError(f"[width parallel {form}] logits {rel:.3e} from one process "
                             f"(int8 itself {own:.3e}), decidable argmax {agree:.4%}, or "
                             "the ranks differ")
    return dict(bit_equal=diff == 0, max_dlogits=diff, rel=rel, int8_rel=own,
                decidable_agreement=agree, decidable_share=clear.float().mean().item())


def phase_width_parallel(device, smi_line):
    """Two ranks on the one card over gloo at ``mesh_shape=(1, 2)``, each
    holding half of every image's columns (``wp_worker``), against one
    process on the same weights, batch and masks (WP_RUNS, the eval step,
    the WP_WIDE-px step plain and under remat "all", WP_ZOO's eval_step and
    step, int8 serving), held at TP_BARS and the int8 reading; the ranks'
    whole states equal; each rank's launches a step equal to one process's;
    warm ms a step and peak memory a rank against one process's; K3f, K4f
    and Q1 on a halo-extended strip against their plain versions."""
    t_phase = time.perf_counter()
    rec = {}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_wp_", dir=root)
    launches = dict.fromkeys(COUNTERS, 0)
    depth = ModelConfig().depth
    wide_want = {remat: lever_launches(remat, 1, flash=2 * depth) for remat in ("none", "all")}
    # key -> (tag, dtype, width, rows, launches a step, launches an eval_step)
    runs = {key: (f"{key[0]} {key[1]}", key[1], WP_WIDTH, WIDE_BATCH,
                  per_step_launches(WP_SWITCHES[key[0]]),
                  per_eval_launches(WP_SWITCHES[key[0]]) if i == 0 else None)
            for i, key in enumerate(WP_RUNS)}
    runs["wide"] = ("fully_fused bfloat16", "bfloat16", WP_WIDE, WIDE_BATCH,
                    wide_want["none"], None)
    runs["wide_remat"] = ("fully_fused bfloat16 remat=all", "bfloat16", WP_WIDE, WIDE_BATCH,
                          wide_want["all"], None)
    for name in WP_ZOO:  # the switches reach none of these stems
        runs[name] = (name, "bfloat16", WP_WIDTH, TPZ_BATCH, per_step_launches({}),
                      per_eval_launches({}))
    try:
        one = _wp_all(False, device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rec["strip_kernels"] = _wp_strip_kernels(device)
        t_ranks = time.perf_counter()
        ranks = run_ranks("--width-parallel-rank", tmp, WP_RANKS, WP_TIMEOUT,
                          "width parallel")
        rec["ranks_s"] = time.perf_counter() - t_ranks
        if [(r["data"], r["model"]) for r in ranks] != [((0, 1), (m, WP_RANKS))
                                                         for m in range(WP_RANKS)]:
            raise AssertionError(f"[width parallel] grid {[r['model'] for r in ranks]}")
        for key, (tag, dtype, width, rows, want, want_eval) in runs.items():
            got, ref = ranks[0][key], one[key]
            for r in ranks[1:]:
                same = r[key]["metrics"] == got["metrics"] and all(
                    torch.equal(v, r[key]["state"][part][k])
                    for part in ("model", "ema_model")
                    for k, v in got["state"][part].items())
                if not same:
                    raise AssertionError(f"[width parallel] {key}: the ranks' metrics or "
                                         "whole weights differ")
            for who, run in [("one process", ref)] + [(f"rank {i}", r[key])
                                                      for i, r in enumerate(ranks)]:
                for step in run["launches"]:
                    if {k: v for k, v in step.items() if v} != want:
                        raise AssertionError(f"[width parallel] {key}: a step of {who} "
                                             f"launched {step}; expected {want}")
                    launches = {k: launches[k] + step[k] for k in COUNTERS}
            ok, rel, held = held_to_one(got, ref, TP_BARS[dtype], ref["noise_leaves"])
            peaks = [r[key]["peak_mib"] for r in ranks]
            (rank_ms, rank_first), (one_ms, one_first) = (warm_ms(got["times"]),
                                                          warm_ms(ref["times"]))
            line = (f"[width parallel {tag}] {WP_RANKS} ranks on one card over gloo at mesh "
                    f"(1, {WP_RANKS}), {width // WP_RANKS} of {width} px a rank, bs {rows}, "
                    f"{len(got['metrics'])} compared step(s), against one process on the "
                    "same weights, batch and masks: relative gaps a step "
                    + "; ".join(f"{k} " + " ".join(f"{v:.3e}" for v in vs)
                                for k, vs in rel.items())
                    + f" (bars: the first step's losses {TP_BARS[dtype]['first_loss']} and "
                    f"grad_norm {TP_BARS[dtype]['first_grad_norm']}, every step's "
                    f"{TP_BARS[dtype]['loss']} and {TP_BARS[dtype]['grad_norm']}; "
                    f"{'deterministic algorithms' if dtype in DP_DETERMINISTIC else 'default mode'}"
                    f"); {gaps(held)}; launches a step {want}; warm ms a step (the median "
                    f"after the first of {len(got['times'])}), rank 0 {rank_ms:.3f}, one process "
                    f"{one_ms:.3f} (first step {rank_first:.3f} / {one_first:.3f}); peak "
                    "MiB a rank " + " / ".join(f"{p:.1f}" for p in peaks)
                    + f", one process {ref['peak_mib']:.1f}")
            if key == "wide_remat":
                plain_peaks = [r["wide"]["peak_mib"] for r in ranks]
                line += (f"; remat 'all' against the ranks without it in this run "
                         + " / ".join(f"{p:.1f}" for p in plain_peaks)
                         + f" MiB and the one-step reading {WP_WIDE_RANK_PEAK_MIB} MiB")
            if not ok:
                raise AssertionError(f"[width parallel {key}] two ranks outside the bars: "
                                     f"{held}, {rel}")
            if key in ("wide", "wide_remat") and not max(peaks) < ref["peak_mib"]:
                raise AssertionError(f"[width parallel {key}] at {WP_WIDE} px a rank's peak "
                                     f"{peaks} MiB is not below one process's "
                                     f"{ref['peak_mib']:.1f}")
            rec["/".join(key) if isinstance(key, tuple) else key] = entry = dict(
                rel=rel, held=held, rank_ms=rank_ms, one_ms=one_ms, rank_first_ms=rank_first,
                one_first_ms=one_first, rank_peak_mib=peaks, one_peak_mib=ref["peak_mib"],
                rank_launches=got["launches"][0])
            if want_eval is not None:
                ev, ev1 = got["eval"], ref["eval"]
                for who, e in [("one process", ev1)] + [(f"rank {i}", r[key]["eval"])
                                                        for i, r in enumerate(ranks)]:
                    for counted in ("launches", "warm_launches"):
                        if {k: v for k, v in e[counted].items() if v} != want_eval:
                            raise AssertionError(f"[width parallel] {key} eval_step of {who} "
                                                 f"launched {e[counted]}; expected "
                                                 f"{want_eval}")
                        launches = {k: launches[k] + e[counted][k] for k in COUNTERS}
                if not all(torch.equal(r[key]["eval"]["logits"], ev["logits"]) for r in ranks):
                    raise AssertionError(f"[width parallel] {key}: the ranks' eval logits "
                                         "differ")
                loss_rel = abs(ev["loss"] - ev1["loss"]) / abs(ev1["loss"])
                agree = (ev["logits"].argmax(-1) == ev1["logits"].argmax(-1)).float().mean()
                err = (ev["logits"] - ev1["logits"]).abs().max().item()
                line += (f"; eval_step loss {ev['loss']:.5f} (one process {ev1['loss']:.5f}, "
                         f"{loss_rel:.3e} rel), max |logit gap| {err:.3e}, frame argmax "
                         f"agreement {agree.item():.4%}, launches {want_eval}, warm ms rank 0 "
                         f"{ev['ms']:.3f}, one process {ev1['ms']:.3f}")
                floor = MIN_ARGMAX_AGREEMENT if key == WP_RUNS[0] else 0.0
                if loss_rel > TP_BARS["bfloat16"]["loss"] or agree.item() < floor:
                    raise AssertionError(f"[width parallel] {key} eval_step: loss "
                                         f"{loss_rel:.3e} rel, argmax agreement {agree:.4%}")
                entry["eval"] = dict(loss_rel=loss_rel, argmax_agreement=agree.item(),
                                     max_abs_err=err, rank_ms=ev["ms"], one_ms=ev1["ms"])
            say(line + f"; {smi_line}")
        for form, kw in WP_INT8_FORMS.items():
            want = int8_eval_launches(kw, depth)
            got, ref = ranks[0][form], one[form]
            for who, run in [("one process", ref)] + [(f"rank {i}", r[form])
                                                      for i, r in enumerate(ranks)]:
                for counted in ("launches", "warm_launches"):
                    if {k: v for k, v in run[counted].items() if v} != want:
                        raise AssertionError(f"[width parallel {form}] eval_step of {who} "
                                             f"launched {run[counted]}; expected {want}")
                    launches = {k: launches[k] + run[counted][k] for k in COUNTERS}
            held8 = _wp_held_int8(form, got, ref, one["float32"], ranks)
            stats_off = sorted(k for k, v in ref["stats"].items() if got["stats"][k] != v)
            rec[form] = dict(held8, stats_off=stats_off, rank_ms=got["eval_ms"],
                             one_ms=ref["eval_ms"])
            say(f"[width parallel {form}] the int8 flagship at {WP_WIDTH} px, bs {TPZ_BATCH}, "
                f"{WP_WIDTH // WP_RANKS} px a rank, calibrated on one batch of strips, static "
                "eval_step: logits "
                + ("bit-equal to one process's" if held8["bit_equal"] else
                   f"{held8['max_dlogits']:.4f} max |d| from one process's "
                   f"({held8['rel']:.3e} relative L2; decidable argmax "
                   f"{held8['decidable_agreement']:.4%} of {held8['decidable_share']:.2%})")
                + f" (int8 against float32 {held8['int8_rel']:.3e}); abs-maxes that differ: "
                f"{stats_off[:4] or 'none'} of {len(ref['stats'])}; launches {want}; warm "
                f"ms rank 0 {got['eval_ms']:.3f}, one process {ref['eval_ms']:.3f}; "
                f"{smi_line}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    say(f"[width parallel] phase {rec['phase_s']:.1f} s (ranks {rec['ranks_s']:.1f} s); "
        f"launches {launches}; {smi_line}")
    return launches, rec


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
    zoo_launches, zoo_rec = phase_zoo_serve(device, smi_line)
    sgm_launches, sgm_rec = phase_sgm_mms_train(device, smi_line)
    standalone_launches, standalone_rec = phase_zoo_standalone(device, smi_line)
    ed_launches, ed_rec = phase_encoder_decoder(device, smi_line)
    int8_launches, int8_rec = phase_int8_serve(device, smi_line)
    deploy_launches, deploy_rec = phase_deploy_serve(device, smi_line)
    lever_launches_, lever_rec = phase_memory_levers(device, smi_line, full["ms"])
    dp_launches, dp_rec = phase_data_parallel(device, smi_line)
    mw_launches, mw_rec = phase_multiwidth(device, smi_line)
    tp_launches, tp_rec = phase_tensor_parallel(device, smi_line)
    tpz_launches, tpz_rec = phase_tensor_parallel_zoo(device, smi_line)
    wp_launches, wp_rec = phase_width_parallel(device, smi_line)
    say(f"[done] build {build_s:.2f} s; {smi_line}")
    main_path = {k: fused_serve[k] + full_serve[k] + fused_train[k] + full_train[k]
                 + train_launches[k] + bucket_serve[k] + wide_train[k] + fit_launches[k]
                 + zoo_launches[k] + sgm_launches[k] + standalone_launches[k]
                 + ed_launches[k] + int8_launches[k] + deploy_launches[k]
                 + lever_launches_[k] + dp_launches[k] + mw_launches[k] + tp_launches[k]
                 + tpz_launches[k] + wp_launches[k] for k in COUNTERS}
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
    q1 = int8_rec["sites"]["s1_conv2"]
    int8_lines = [{
        "name": "conv_int8",
        "route": "cuda",
        "source": "htr_vt_torch/csrc/conv_int8.cu",
        "replaces": "htr_vt_tpu/ops/quant.py:55 (conv_int8 / conv_int8_bf16: XLA's s8 "
                    "conv_general_dilated, not a Pallas kernel)",
        "launches": main_path["conv_int8"],
        "max_abs_err": max(r["max_abs_err"] for r in int8_rec["sites"].values()),
        "ms": q1["ms"],
        "plain_ms": q1["plain_ms"],
        "bound_ms": q1["bound_ms"],
        "bound_by": q1["bound_by"],
        "library_ms": q1["library_ms"],
        "library": "im2col (a strided view, copied) + torch._int_mm",
        "call_ms": q1["call_ms"],
        "shape": "bf16 [128, 256, 8, 512] channels-last with the BN prologue, "
                 "256 -> 256, 3x3/1 (stage 1's conv2 site, 2 a forward)",
        "sites": int8_rec["sites"],
        "forward_ms": int8_rec["q1_forward_ms"],
        "forward_bound_ms": int8_rec["q1_forward_bound_ms"],
        "width_strips": {k: v for k, v in wp_rec["strip_kernels"].items()
                         if k.startswith("conv_int8")},
    }]
    say(json.dumps({"kernels": ctc + stem_lines + conv_lines + flash_lines + int8_lines,
                    "bucket_serve": bucket_rec, "wide_train": wide_rec,
                    "train_ms": train["ms"], "fused_train_ms": fused["ms"],
                    "fully_fused_train_ms": full["ms"], "train_peak": train["peak"],
                    "fused_train_peak": fused["peak"],
                    "fully_fused_train_peak": full["peak"],
                    "fully_fused_first_loss": full["first_loss"],
                    "stock_first_loss": train["first_loss"],
                    "conv_grad_copies": full["conv_grad_copies"],
                    "pool_grad_copies": fused["grad_copies"] + full["grad_copies"],
                    "fully_fused_serve": full_serve_rec, "fit": fit_rec,
                    "zoo_serve": zoo_rec, "sgm_mms_train": sgm_rec,
                    "zoo_standalone": standalone_rec, "encoder_decoder": ed_rec,
                    "int8_serve": {k: v for k, v in int8_rec.items() if k != "sites"},
                    "deploy_serve": deploy_rec, "memory_levers": lever_rec,
                    "data_parallel": dp_rec, "multiwidth": mw_rec,
                    "tensor_parallel": tp_rec, "tensor_parallel_zoo": tpz_rec,
                    "width_parallel": wp_rec}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--data-parallel-rank"]:
        dp_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--tensor-parallel-rank"]:
        tp_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--tensor-parallel-zoo-rank"]:
        tpz_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--width-parallel-rank"]:
        wp_worker(sys.argv[2])
    else:
        main()
