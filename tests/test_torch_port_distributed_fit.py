"""Data parallel with the memory levers and through ``fit``, two ``gloo``
processes on the CPU (the launch of ``tests/test_torch_port_distributed.py``):

- two ranks x ``grad_accum`` 2 against JAX's single-process step on the
  row-permuted global batch. The port cuts each rank's own rows into
  microbatches, so its microbatch i is rank 0's slice i and rank 1's slice
  i; JAX cuts the global batch, so the same microbatches come from the batch
  whose rows are ordered that way (the mean loss does not depend on row
  order). Held at the one-step bars of ``test_torch_port_memory_levers.py``;
- ``fit`` on two ranks (tiny SYNTH run, global batch 8): one run.log and one
  set of checkpoints, written by rank 0, and a second run with
  ``resume="auto"`` that restores the same checkpoint on both ranks.
"""

import dataclasses
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from htr_vt_tpu.config import MaskConfig, TrainConfig
from htr_vt_tpu.models import masking as jmasking
from htr_vt_torch.config import config_to_dict
from test_torch_port_distributed import WORKER, launch
from test_torch_port_loop import tiny_experiment
from test_torch_port_memory_levers import (RANKS_STEADY_SHARE, check_against_jax, jax_init,
                                           jax_step, port_state, tiny_batch, tiny_cfg)
from test_torch_port_model import port_config

B, N, G, RANKS = 8, 16, 2, 2

FIT_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
sys.modules["torch.utils.tensorboard"] = None  # TensorFlow's import, ~20 s
sys.path.insert(0, os.environ["HTRVT_REPO"])
from htr_vt_torch.config import ExperimentConfig, config_from_dict
from htr_vt_torch.parallel import mesh
from htr_vt_torch.train import loop
from htr_vt_torch.train.checkpoint import CheckpointManager

restored = []
restore = CheckpointManager.restore


def recorded(self, path, template):
    out = restore(self, path, template)
    restored.append((os.path.basename(path), int(template.step)))
    return out


CheckpointManager.restore = recorded
job = torch.load(os.environ["HTRVT_JOB"], weights_only=False)
results = [loop.fit(config_from_dict(ExperimentConfig, c), device="cpu") for c in job]
torch.save({"results": results, "restored": restored, "world": mesh.world()},
           os.path.join(os.environ["HTRVT_OUT"], f"rank{mesh.world()[0]}.pt"))
"""


def test_two_ranks_with_grad_accum_match_jax_on_the_permuted_batch(tmp_path, monkeypatch):
    cfg = tiny_cfg(TrainConfig(total_iters=100, grad_accum=G))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, masking=MaskConfig(mode="span", ratio=0.4, max_span_length=4)))
    batch = tiny_batch(60, B)
    init = jax_init(cfg, 6, batch)
    rng = np.random.default_rng(61)
    # one mask a pass for a global microbatch of B // G rows
    masks = [(rng.random((B // G, N, 1)) > 0.4).astype(np.float32) for _ in range(2)]
    job = {"accum": dict(cfg=config_to_dict(port_config(cfg)), seed=0, batches=[batch],
                         init=port_state(cfg, init).model.state_dict(),
                         masks=[torch.from_numpy(m) for m in masks for _ in range(G)])}
    ranks = launch(WORKER, tmp_path, job)
    local, micro = B // RANKS, B // RANKS // G
    perm = [r * local + i * micro + j for i in range(G) for r in range(RANKS)
            for j in range(micro)]
    assert perm == [0, 1, 4, 5, 2, 3, 6, 7]
    calls = []

    def jax_mask(*a, **k):
        calls.append(None)
        return jnp.asarray(masks[len(calls) - 1])

    monkeypatch.setattr(jmasking, "build_keep_mask", jax_mask)
    want, state = jax_step(cfg, init, {k: v[perm] for k, v in batch.items()})
    assert len(calls) == 2
    r0 = ranks[0]["accum"]
    assert r0["metrics"] == ranks[1]["accum"]["metrics"]
    port = port_state(cfg, init)
    port.model.load_state_dict(r0["model"])
    check_against_jax(r0["metrics"][0], port, want, state,
                      steady_share=RANKS_STEADY_SHARE)


def test_fit_on_two_ranks_writes_once_and_resumes_alike(tmp_path):
    first, second = (dataclasses.replace(c, train=dataclasses.replace(c.train, eval_iters=2))
                     for c in (tiny_experiment(tmp_path, "dp", total=4),
                               tiny_experiment(tmp_path, "dp", total=6, resume="auto")))
    ranks = launch(FIT_WORKER, tmp_path, [config_to_dict(c) for c in (first, second)])
    assert [r["world"] for r in ranks] == [(0, 2), (1, 2)]
    assert ranks[0]["results"] == ranks[1]["results"]  # eval gathers every row
    for r in ranks:
        assert [(os.path.basename(p), s) for p, s in r["restored"]] == \
            [(os.path.basename(ranks[0]["restored"][0][0]), 4)]
    run = os.path.join(str(tmp_path), "dp")
    assert sorted(os.listdir(run)).count("run.log") == 1
    with open(os.path.join(run, "run.log")) as f:
        log = f.read()
    assert log.count("Start training...") == 2 and log.count("auto-resume found") == 1
    steps = sorted(int(json.load(open(os.path.join(p, "meta.json")))["step"])
                   for p in glob.glob(os.path.join(run, "checkpoint_*")))
    assert steps == [2, 4, 6]
    assert os.path.isdir(os.path.join(run, "best_CER"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        evals = [json.loads(line) for line in f if "val/CER" in line]
    assert [e["step"] for e in evals] == [2, 4, 6]
