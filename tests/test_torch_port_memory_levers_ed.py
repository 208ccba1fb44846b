"""remat through the encoder-decoder's ``HTRVT`` trunk (JAX
``encoder_decoder.py:141``: the trunk is an ``HTRVT`` at the same config, so
``cfg.remat`` reaches its stem and blocks; the decoder is not wrapped),
against the JAX package on the CPU at the tiny float32 config of
``tests/test_torch_port_ed.py``: one SAM step under ``remat="all"`` from the
same weights, batch and keep mask, held at the one-step bars of
``test_torch_port_memory_levers.py``, and bit for bit to the port's plain
step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from htr_vt_tpu.config import ExperimentConfig
from htr_vt_tpu.models import masking as jmasking
from htr_vt_torch.models import masking
from test_torch_port_ed import B, N, _images, _targets, ed_config
from test_torch_port_memory_levers import (OPTIM, assert_same_state, check_against_jax,
                                           jax_init, jax_step, port_step)


def test_encoder_decoder_trunk_remat_matches_jax_and_the_plain_step(monkeypatch):
    cfg = ExperimentConfig(model=ed_config(remat="all"), optim=OPTIM)
    keep = (np.random.default_rng(15).random((B, N, 1)) > 0.3).astype(np.float32)
    tin, tout, tlen = _targets(16)
    batch = {"image": _images(17), "labels": np.zeros((B, 4), np.int32),
             "label_lengths": np.zeros(B, np.int32), "ed_input": tin, "ed_output": tout,
             "ed_lengths": tlen}
    init = jax_init(cfg, 5, batch)
    monkeypatch.setattr(jmasking, "build_keep_mask", lambda *a, **k: jnp.asarray(keep))
    monkeypatch.setattr(masking, "build_keep_mask", lambda *a, **k: torch.from_numpy(keep))
    want, state = jax_step(cfg, init, batch)
    got, port = port_step(cfg, init, batch)
    check_against_jax(got, port, want, state)
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat="none"))
    plain, plain_port = port_step(plain_cfg, init, batch)
    assert got == plain
    assert_same_state(port, plain_port, "encoder-decoder")
