"""Checkpoints on ``torch.save`` (port of ``htr_vt_tpu/train/checkpoint.py``).

The JAX package's layout (``checkpoint.py:54-117``): per-eval rolling
``checkpoint_{cer:.4f}_{wer:.4f}_{iter}/`` directories plus ``best_CER`` /
``best_WER`` copies, each holding one state file and ``meta.json``; the
newest ``keep`` rolling directories stay. Here the state file is
``state.pt``, one ``torch.save`` of the model, the EMA model (parameters and
BN running statistics), the AdamW state, ``step`` and the masking/dropout
``torch.Generator`` state. With those, resume is exact: the loader's batch b
is a pure function of (seed, b) (``data/loader.py``), so restoring ``step``
resumes the data and augmentation stream too, and "train N" equals "train
k, resume, train N - k" (``tests/test_torch_port_loop.py``).

A state sharded over a model axis (``parallel/mesh.py:shard_model``) is
saved in the one-process layout (``gather_state_dict``,
``gather_optimizer_state``) and cut to the ranks' parts on restore, so a
checkpoint moves between one process and any mesh.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from htr_vt_torch.config import ExperimentConfig, ModelConfig, config_from_dict
from htr_vt_torch.models.htr_vt import HTRVT, build_model
from htr_vt_torch.ops.quant import serving_arrays
from htr_vt_torch.parallel.mesh import (barrier, gather_optimizer_state, gather_state_dict,
                                        shard_optimizer_state, shard_state_dict, world)
from htr_vt_torch.train.state import TrainState

_CKPT_RE = re.compile(r"checkpoint_(?P<cer>[\d.]+)_(?P<wer>[\d.]+)_(?P<iter>\d+)$")
STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, save_dir: str, keep: int = 5):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self.keep = keep

    # -- paths ------------------------------------------------------------
    def _rolling_name(self, cer: float, wer: float, step: int) -> str:
        return f"checkpoint_{cer:.4f}_{wer:.4f}_{step}"

    def list_rolling(self):
        out = []
        for name in os.listdir(self.save_dir):
            m = _CKPT_RE.match(name)
            if m:
                out.append((int(m.group("iter")), name))
        return sorted(out)

    def latest_path(self) -> Optional[str]:
        rolling = self.list_rolling()
        return os.path.join(self.save_dir, rolling[-1][1]) if rolling else None

    # -- save -------------------------------------------------------------
    def save(self, state: TrainState, *, cer: float, wer: float,
             best_cer: float, best_wer: float, meta: Optional[Dict] = None) -> str:
        """Write the rolling directory of ``state.step``, refresh the
        best_CER / best_WER copies where this eval ties or beats the best,
        and drop all but the newest ``keep`` rolling directories.

        Under data parallelism every rank calls this in lockstep, with the
        same state (``checkpoint.py:72-100``): rank 0 writes, then all meet
        at a barrier, so no rank reads or lists the directory before the
        files are whole. Over a model axis every rank first gathers its
        shards (the one-process layout), in lockstep too."""
        step = int(state.step)
        path = os.path.join(self.save_dir, self._rolling_name(cer, wer, step))
        payload = {"model": gather_state_dict(state.model),
                   "ema_model": gather_state_dict(state.ema_model),
                   "optimizer": gather_optimizer_state(state.model, state.optimizer),
                   "step": step,
                   "generator": state.generator.get_state()}
        if world()[0] == 0:
            self._save_state(path, payload, cer=cer, wer=wer, best_cer=best_cer,
                             best_wer=best_wer, meta=meta)
            if cer <= best_cer:
                self._copy(path, os.path.join(self.save_dir, "best_CER"))
            if wer <= best_wer:
                self._copy(path, os.path.join(self.save_dir, "best_WER"))
            self._cleanup()
        barrier()
        return path

    def _save_state(self, path: str, payload: Dict[str, Any], **meta_kw) -> None:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(payload, os.path.join(path, STATE_FILE))
        meta = dict(meta_kw.pop("meta", None) or {})
        meta.update({"step": payload["step"]})
        meta.update({k: v for k, v in meta_kw.items() if v is not None})
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=float)

    def _copy(self, src: str, dst: str) -> None:
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(src, dst)

    def _cleanup(self) -> None:
        rolling = self.list_rolling()
        for _, name in rolling[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.save_dir, name), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def resolve(self, path: str) -> str:
        """A rolling or best_CER/best_WER directory as it is; a run directory
        (this manager's save_dir or another) means its latest rolling
        directory."""
        path = os.path.abspath(path)
        if os.path.basename(path) not in ("best_CER", "best_WER") and \
                not _CKPT_RE.match(os.path.basename(path)):
            run = self if path == self.save_dir or not os.path.isdir(path) \
                else CheckpointManager(path)
            latest = run.latest_path()
            if latest is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
            path = latest
        return path

    def meta(self, path: str) -> Dict:
        """The meta.json of a checkpoint directory (``resolve``); without one
        the metrics come from the directory name, the reference's filename
        convention (model_v1/utils/utils.py:246-251)."""
        path = self.resolve(path)
        meta_path = os.path.join(path, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                return json.load(f)
        m = _CKPT_RE.match(os.path.basename(path))
        if m:
            return {"cer": float(m.group("cer")), "wer": float(m.group("wer")),
                    "step": int(m.group("iter"))}
        return {}

    def read(self, path: str) -> Tuple[Dict[str, Any], Dict]:
        """(the state file's contents on the CPU, ``meta``) of a checkpoint
        directory (``resolve``)."""
        path = self.resolve(path)
        payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                             weights_only=True)
        return payload, self.meta(path)

    def restore(self, path: str, template: TrainState) -> Tuple[TrainState, Dict]:
        """Load the checkpoint at ``path`` (a rolling dir, best_CER/best_WER,
        or the save_dir -> latest) into ``template`` in place: model, EMA,
        AdamW, step and generator, each cut to this rank's parts where the
        template is sharded over a model axis. Returns (template, meta)."""
        payload, meta = self.read(path)
        for name in ("model", "ema_model"):
            load_module_state(getattr(template, name), payload[name], path)
        template.optimizer.load_state_dict(
            shard_optimizer_state(template.model, payload["optimizer"]))
        template.step = int(payload["step"])
        template.generator.set_state(payload["generator"])
        return template, meta


def load_module_state(module: torch.nn.Module, sd: Dict[str, torch.Tensor],
                      path: str = "checkpoint") -> None:
    """``module.load_state_dict(sd, strict=True)``, or, where the module's
    keys are a strict subset of the checkpoint's, the subset alone: the JAX
    package's partial restore of an eval template from an SGM-trained
    checkpoint, whose ``sgm_head`` is a training-only head
    (``htr_vt_tpu/train/checkpoint.py:135-164``). The check is structural;
    any other mismatch raises as a strict load does. ``sd`` is in the
    one-process layout; a module sharded over a model axis takes its
    parts (``parallel/mesh.py:shard_state_dict``)."""
    have, saved = set(module.state_dict()), set(sd)
    if have < saved:
        logging.getLogger("htr_vt_torch").info(
            "%s: the model's %d entries are a strict subset of the checkpoint's %d "
            "(%s...); restoring the subset", path, len(have), len(saved),
            sorted(saved - have)[:4])
        sd = {k: v for k, v in sd.items() if k in have}
    module.load_state_dict(shard_state_dict(module, sd), strict=True)


def saved_config(meta: Dict) -> Optional[ExperimentConfig]:
    """The ExperimentConfig a checkpoint's meta.json carries (the training
    loop saves it, with nb_cls fitted to the alphabet), or None."""
    d = meta.get("config")
    return None if d is None else config_from_dict(ExperimentConfig, d)


def load_ema_model(path: str, cfg: Optional[ModelConfig], device) -> HTRVT:
    """A model holding the EMA weights (parameters and BN running
    statistics) of the checkpoint at ``path`` (``CheckpointManager.resolve``),
    the weights the JAX package evaluates and serves. Built at ``cfg``, or
    at the model config saved with the checkpoint when ``cfg`` is None; an
    int8 ``cfg`` gets the training widths adapted (``ops/quant.py:
    serving_arrays``, the stage-1 pad)."""
    mgr = CheckpointManager(os.path.dirname(os.path.abspath(path).rstrip("/")) or ".")
    payload, meta = mgr.read(path)
    if cfg is None:
        saved = saved_config(meta)
        if saved is None:
            raise ValueError(f"{path}: meta.json holds no config; give the model config")
        cfg = saved.model
    model = build_model(cfg, device=device)
    load_module_state(model, serving_arrays(cfg, payload["ema_model"]), path)
    return model
