"""The training loop (port of ``htr_vt_tpu/train/loop.py``).

Functional equivalent of the reference's main() (model_v1/train.py:33-231):
data + model + SAM/EMA + periodic EMA-weight validation + best-CER/WER
checkpoints + scalars, with the SAM step running eagerly on one device
(``train/step.py:train_step``) and host-side batching overlapped through
the prefetching loader; data-parallel over several processes
(``parallel/mesh.py``), each rank on its rows of every global batch.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from htr_vt_torch.config import ExperimentConfig, config_to_dict
from htr_vt_torch.data.loader import (TrainLoader, build_dataset, choose_max_label_len,
                                      device_prefetch, eval_batches, make_converter)
from htr_vt_torch.eval.validate import validate
from htr_vt_torch.models.sgm import SGMVocab, make_context_arrays
from htr_vt_torch.text.ed_tokenizer import EDTokenizer
from htr_vt_torch.train.checkpoint import CheckpointManager, load_module_state
from htr_vt_torch.parallel.mesh import (barrier, broadcast_str, data_world, init_mesh,
                                        maybe_initialize_distributed, shard_state_dict,
                                        world)
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import eval_step, eval_step_ed, train_step
from htr_vt_torch.utils.logging import ScalarWriter, StepTimer, get_logger, maybe_profile

# Top-level modules a transfer-learning run (``load_encoder_only``) starts
# fresh, as the JAX loop's head keys (``loop.py:115``): the CTC models'
# ``head`` and ``sgm_head``, the encoder-decoder's ``embed``, ``final_norm``
# and ``lm_head`` (its ``encoder`` and ``dec{i}`` load).
HEAD_KEYS = {"head", "sgm_head", "lm_head", "embed", "final_norm"}


def resolve_device(device, rank: int) -> torch.device:
    """``device`` as given, except a bare ``"cuda"``: card ``rank % count``,
    one card a rank on a machine that has several."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("fit: no CUDA device; pass device='cpu' to train on "
                               "the CPU")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


def fit(cfg: ExperimentConfig, device="cuda",
        datasets: Optional[Sequence] = None) -> Dict[str, float]:
    """Run training to cfg.train.total_iters on ``device`` (the card unless
    the caller asks for the CPU). Returns the best CER and WER.

    ``datasets``: (train, val) objects with ``__len__``, ``__getitem__``
    -> (uint8 [H, W] image, text), ``labels`` and ``alphabet``, in place of
    ``build_dataset(cfg.data, "train" | "val")``: for a machine that cannot
    read or render line images (no PIL, no cv2).

    Data parallel (``loop.py:31-53``): launched as R processes with the
    ``HTRVT_*`` variables (``parallel/mesh.py:maybe_initialize_distributed``),
    every rank runs this function on its ``train_bs // R`` rows of each
    global batch (``cfg.data.train_bs`` is the global batch), on card
    ``rank % count`` for ``device="cuda"``. Rank 0 alone writes run.log,
    the scalars and the checkpoints; ``resume="auto"`` is rank 0's choice,
    broadcast; eval gathers every rank's rows, so the best-checkpoint
    decisions agree everywhere. The ranks share the run directory (one
    machine or a shared filesystem).

    ``cfg.parallel.mesh_shape=(R, M)`` (``parallel/mesh.py:init_mesh``):
    the R data indices split each global batch as above, and the M ranks of
    one data index hold the same rows and shard the model's attention and
    MLP layers over the model axis; the checkpoints keep the one-process
    layout."""
    maybe_initialize_distributed(device=device)
    rank, _ = world()
    is_main = rank == 0
    init_mesh(cfg.parallel.mesh_shape)
    data_rank, nproc = data_world()
    device = resolve_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    save_dir = os.path.join(cfg.train.out_dir, cfg.train.exp_name)
    os.makedirs(save_dir, exist_ok=True)
    logger = get_logger(save_dir, write_file=is_main)
    if not is_main:
        logger.setLevel(logging.WARNING)
    logger.info(json.dumps(config_to_dict(cfg), indent=2, sort_keys=True, default=str))
    for name, bs in (("train_bs", cfg.data.train_bs), ("val_bs", cfg.data.val_bs)):
        if bs % nproc:
            raise ValueError(f"global {name} {bs} not divisible by the data "
                             f"axis, {nproc} process(es)")

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
    extras_fn, eval_extras_fn, eval_fn, eval_codec = None, None, eval_step, converter
    if cfg.model.model_type == "encoder_decoder":
        # the ED tokenizer over the codec's alphabet; its teacher-forcing
        # arrays ride the loader's extras hook, in training and in eval
        # (loop.py:70-80,168-171,226)
        ed_tokenizer = EDTokenizer.from_ctc_converter(converter)
        ed_len = min(max_label_len + 2, cfg.model.max_seq_len)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, ed_vocab_size=ed_tokenizer.vocab_size))

        def extras_fn(texts):
            tin, tout, tlen = ed_tokenizer.encode_for_training(texts, ed_len)
            return {"ed_input": tin, "ed_output": tout, "ed_lengths": tlen}
        eval_extras_fn, eval_fn, eval_codec = extras_fn, eval_step_ed, ed_tokenizer
    elif cfg.model.sgm.enable:
        # the SGM vocabulary: the codec's symbols and four control tokens;
        # the loader builds each batch's context windows (loop.py:81-92)
        sgm_vocab = SGMVocab(converter)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, sgm=dataclasses.replace(cfg.model.sgm, vocab_size=sgm_vocab.size)))
        sub_len = cfg.model.sgm.sub_len

        def extras_fn(texts):
            return make_context_arrays(texts, sgm_vocab, max_label_len, sub_len)
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
                module.load_state_dict({**module.state_dict(),
                                        **shard_state_dict(module, sd)}, strict=True)
            else:
                load_module_state(module, sd, cfg.train.load_model)
        logger.info("loaded %s weights from %s",
                    "encoder" if cfg.train.load_encoder_only else "model",
                    cfg.train.load_model)

    resume = cfg.train.resume
    if resume == "auto":
        # Elastic restart convenience: pick up the latest rolling checkpoint
        # in the run directory if one exists (fresh start otherwise).
        # rank 0 alone decides and broadcasts: ranks listing the directory
        # each could race rank 0's save and pick different steps
        resume = broadcast_str(ckpt.latest_path() if is_main else None)
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
    loader = TrainLoader(train_ds, converter, cfg.data.train_bs // nproc, max_label_len,
                         augment=cfg.data.augment, seed=cfg.train.seed,
                         num_threads=cfg.data.num_workers, extras_fn=extras_fn,
                         sampling=cfg.data.sampling, start_batch=start_step,
                         shard_rank=data_rank, shard_count=nproc)
    batches = device_prefetch(iter(loader), device)
    writer = ScalarWriter(save_dir, cfg.train.use_wandb, cfg.train.wandb_project,
                          cfg.train.exp_name, config_to_dict(cfg), enabled=is_main)
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
                # the losses are global: every rank takes this branch and
                # enters save() in lockstep
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
                eval_batches(val_ds, converter, cfg.data.val_bs, max_label_len,
                             extras_fn=eval_extras_fn),
                eval_codec, eval_fn)
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
    # no rank leaves (and, say, auto-resumes a next run) before rank 0's last
    # checkpoint is written
    barrier()
    return {"best_cer": best_cer, "best_wer": best_wer}
