"""``grad_accum`` against the JAX package (CPU, tiny float32, the config of
``tests/test_remat_accum.py`` with span masking): one SAM step at
``grad_accum`` 2 and 4 on a batch of 8 from the same weights and keep
masks. JAX scans its microbatches (``_make_accum_grad_fn``), tracing the
body once a pass, so it draws one mask a pass; the port draws a mask a
microbatch, and is handed the same one. Held at the one-step bars of
``test_torch_port_memory_levers.py``: loss, ``grad_norm``, every updated
parameter, and the BN running statistics, which advance once a
microbatch on both stacks.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import MaskConfig, TrainConfig
from htr_vt_tpu.models import masking as jmasking
from htr_vt_torch.models import masking
from test_torch_port_memory_levers import (check_against_jax, jax_init, jax_step, port_step,
                                           tiny_batch, tiny_cfg)

B, N = 8, 16


def accum_cfg(g: int):
    cfg = tiny_cfg(TrainConfig(total_iters=100, grad_accum=g))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, masking=MaskConfig(mode="span", ratio=0.4, max_span_length=4)))


@pytest.mark.parametrize("g", [2, 4])
def test_grad_accum_step_matches_jax(g, monkeypatch):
    cfg = accum_cfg(g)
    rng = np.random.default_rng(7)
    masks = [(rng.random((B // g, N, 1)) > 0.4).astype(np.float32) for _ in range(2)]
    batch = tiny_batch(8, B)
    init = jax_init(cfg, 2, batch)
    calls = []

    def jax_mask(*a, **k):
        calls.append(None)
        return jnp.asarray(masks[(len(calls) - 1) % 2])

    monkeypatch.setattr(jmasking, "build_keep_mask", jax_mask)
    want, state = jax_step(cfg, init, batch)
    assert len(calls) == 2  # the scan body traced once a pass
    port_masks = iter([torch.from_numpy(m) for m in masks for _ in range(g)])
    monkeypatch.setattr(masking, "build_keep_mask", lambda *a, **k: next(port_masks))
    got, port = port_step(cfg, init, batch)
    assert next(port_masks, None) is None  # one draw a microbatch and pass
    check_against_jax(got, port, want, state)
