"""The training loop (port of ``htr_vt_tpu/train/loop.py``), one process.

Functional equivalent of the reference's main() (model_v1/train.py:33-231):
data + model + SAM/EMA + periodic EMA-weight validation + best-CER/WER
checkpoints + scalars, with the SAM step running eagerly on one device
(``train/step.py:train_step``) and host-side batching overlapped through
the prefetching loader. Multi-process training is not ported yet
(ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from htr_vt_torch.config import ExperimentConfig, config_to_dict
from htr_vt_torch.data.loader import (TrainLoader, build_dataset, choose_max_label_len,
                                      device_prefetch, eval_batches, make_converter)
from htr_vt_torch.eval.validate import validate
from htr_vt_torch.train.checkpoint import CheckpointManager, load_module_state
from htr_vt_torch.train.state import check_ported, create_train_state
from htr_vt_torch.train.step import train_step
from htr_vt_torch.utils.logging import ScalarWriter, StepTimer, get_logger, maybe_profile

# Top-level modules a transfer-learning run (``load_encoder_only``) starts
# fresh, as the JAX loop's head keys (``loop.py:115``); the flagship has
# ``head`` alone.
HEAD_KEYS = {"head", "sgm_head", "lm_head", "embed", "final_norm"}


def check_single_process(cfg: ExperimentConfig) -> None:
    """Raise where the config or the launch asks for more than one process
    or device: data parallelism is not ported yet."""
    mesh = cfg.parallel.mesh_shape
    procs = int(os.environ.get("HTRVT_NUM_PROCESSES", "1"))
    if (mesh is not None and math.prod(mesh) > 1) or procs > 1:
        raise NotImplementedError(
            f"mesh_shape={mesh}, {procs} process(es): multi-device training is not "
            "ported to htr_vt_torch yet (ROADMAP.md queue 1, item 12: distributed)")


def fit(cfg: ExperimentConfig, device="cuda",
        datasets: Optional[Sequence] = None) -> Dict[str, float]:
    """Run training to cfg.train.total_iters on ``device`` (the card unless
    the caller asks for the CPU). Returns the best CER and WER.

    ``datasets``: (train, val) objects with ``__len__``, ``__getitem__``
    -> (uint8 [H, W] image, text), ``labels`` and ``alphabet``, in place of
    ``build_dataset(cfg.data, "train" | "val")``: for a machine that cannot
    read or render line images (no PIL, no cv2)."""
    check_single_process(cfg)
    check_ported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit: no CUDA device; pass device='cpu' to train on the CPU")
    save_dir = os.path.join(cfg.train.out_dir, cfg.train.exp_name)
    os.makedirs(save_dir, exist_ok=True)
    logger = get_logger(save_dir)
    logger.info(json.dumps(config_to_dict(cfg), indent=2, sort_keys=True, default=str))

    # ---- data ----
    if datasets is None:
        train_ds = build_dataset(cfg.data, "train")
        val_ds = build_dataset(cfg.data, "val")
    else:
        train_ds, val_ds = datasets
    converter = make_converter(cfg.data, train_ds)
    if converter.num_classes != cfg.model.nb_cls:
        logger.info("adjusting nb_cls %d -> %d (alphabet size)",
                    cfg.model.nb_cls, converter.num_classes)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, nb_cls=converter.num_classes))
    max_label_len = choose_max_label_len(train_ds.labels, cfg.model.num_tokens)
    logger.info("train=%d val=%d alphabet=%d max_label_len=%d",
                len(train_ds), len(val_ds), converter.num_classes, max_label_len)

    # ---- state ----
    state = create_train_state(cfg, device,
                               torch.Generator(device=device).manual_seed(cfg.train.seed))
    logger.info("total_param is %d", sum(p.numel() for p in state.model.parameters()))

    ckpt = CheckpointManager(save_dir, keep=cfg.train.keep_checkpoints)
    best_cer, best_wer, start_step = 1e6, 1e6, 0

    if cfg.train.load_model:
        # Weight-only initialization (fresh optimizer/step); optionally just
        # the encoder trunk for transfer learning.
        src_mgr = CheckpointManager(os.path.dirname(
            cfg.train.load_model.rstrip("/")) or ".")
        loaded, _ = src_mgr.read(cfg.train.load_model)
        for name in ("model", "ema_model"):
            module, sd = getattr(state, name), loaded[name]
            if cfg.train.load_encoder_only:
                sd = {k: v for k, v in sd.items() if k.split(".")[0] not in HEAD_KEYS}
                module.load_state_dict({**module.state_dict(), **sd}, strict=True)
            else:
                load_module_state(module, sd, cfg.train.load_model)
        logger.info("loaded %s weights from %s",
                    "encoder" if cfg.train.load_encoder_only else "model",
                    cfg.train.load_model)

    resume = cfg.train.resume
    if resume == "auto":
        # Elastic restart convenience: pick up the latest rolling checkpoint
        # in the run directory if one exists (fresh start otherwise).
        resume = ckpt.latest_path()
        if resume:
            logger.info("auto-resume found %s", resume)
    if resume:
        state, meta = ckpt.restore(resume, state)
        best_cer = float(meta.get("best_cer", best_cer))
        best_wer = float(meta.get("best_wer", best_wer))
        start_step = int(state.step)
        logger.info("resumed at step %d (best CER %.4f WER %.4f)",
                    start_step, best_cer, best_wer)

    # start_batch=start_step makes resume STREAM-EXACT: the loader's batch b
    # is a pure function of (seed, b), and exactly one batch is consumed per
    # step, so "train N" == "train k, resume, train N-k" batch-for-batch
    # (tests/test_torch_port_loop.py pins the equivalence).
    loader = TrainLoader(train_ds, converter, cfg.data.train_bs, max_label_len,
                         augment=cfg.data.augment, seed=cfg.train.seed,
                         num_threads=cfg.data.num_workers,
                         sampling=cfg.data.sampling, start_batch=start_step)
    batches = device_prefetch(iter(loader), device)
    writer = ScalarWriter(save_dir, cfg.train.use_wandb, cfg.train.wandb_project,
                          cfg.train.exp_name, config_to_dict(cfg))
    # Rate windows close at the print cadence, AFTER the loss fetch syncs the
    # host on that window's device work (StepTimer docstring).
    timer = StepTimer()

    train_loss, train_loss_count = 0.0, 0
    pending_losses: list = []  # device scalars; fetched at print cadence so
    # the host never stalls the launch queue with per-step syncs.
    logger.info("Start training...")
    for step in range(start_step, cfg.train.total_iters):
        maybe_profile(cfg.train.profile_dir, step)
        batch = next(batches)
        metrics = train_step(state, batch)
        pending_losses.append(metrics["loss"])

        it = step + 1
        if it % cfg.train.print_iters == 0:
            fetched = [float(x) for x in pending_losses]
            pending_losses.clear()
            timer.close_window(len(fetched), cfg.data.train_bs)

            # Failure detection: a window of non-finite losses aborts with an
            # emergency checkpoint instead of silently corrupting the run
            # (detection latency = print_iters steps; the reference has none).
            bad = sum(not np.isfinite(v) for v in fetched)
            if cfg.train.max_nonfinite_steps > 0 and bad >= cfg.train.max_nonfinite_steps:
                ckpt.save(state, cer=999.0, wer=999.0, best_cer=best_cer,
                          best_wer=best_wer,
                          meta={"emergency": True, "config": config_to_dict(cfg)})
                loader.close()
                writer.close()
                raise FloatingPointError(
                    f"{bad} non-finite losses in the last {len(fetched)} steps; "
                    f"emergency checkpoint saved in {save_dir}")

            train_loss += sum(v for v in fetched if np.isfinite(v))
            train_loss_count += len(fetched)
            avg = train_loss / max(1, train_loss_count)
            logger.info("Iter : %d \t training loss : %.5f \t img/s : %.1f",
                        it, avg, timer.rate)
            writer.write(it, {"train/loss": avg, "train/imgs_per_sec": timer.rate,
                              "train/grad_norm": float(metrics["grad_norm"])})
            train_loss, train_loss_count = 0.0, 0

        if it % cfg.train.eval_iters == 0 or it == cfg.train.total_iters:
            val_loss, cer, wer, _, _ = validate(
                state.ema_model,
                eval_batches(val_ds, converter, cfg.data.val_bs, max_label_len),
                converter)
            improved_cer, improved_wer = cer < best_cer, wer < best_wer
            best_cer, best_wer = min(cer, best_cer), min(wer, best_wer)
            ckpt.save(state, cer=cer, wer=wer, best_cer=best_cer,
                      best_wer=best_wer, meta={"config": config_to_dict(cfg)})
            logger.info("Val. loss : %.3f \t CER : %.4f \t WER : %.4f%s%s",
                        val_loss, cer, wer,
                        " [best CER]" if improved_cer else "",
                        " [best WER]" if improved_wer else "")
            writer.write(it, {"val/loss": val_loss, "val/CER": cer, "val/WER": wer,
                              "val/best_CER": best_cer, "val/best_WER": best_wer})
            # reset the rate window so eval/checkpoint wall time doesn't
            # deflate the next printed train img/s
            timer.close_window(0, 0)

    loader.close()
    writer.close()
    return {"best_cer": best_cer, "best_wer": best_wer}
