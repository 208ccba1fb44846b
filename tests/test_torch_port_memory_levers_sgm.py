"""``grad_accum`` through the tri-masked MMS trainer with the SGM head,
against the JAX package (CPU, tiny float32: the vit recipe of
``tests/test_remat_accum.py`` with the SGM head of
``tests/test_torch_port_sgm.py``, its gate open): one SAM step at
``grad_accum`` 2 on a batch of 4, each microbatch running the three masked
forwards (random .30 / block .20 / span_old .20), from the same weights
and one fixed keep mask a mode. Held at the one-step bars of
``test_torch_port_memory_levers.py``; the SGM head's parameters with the
rest.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from htr_vt_tpu.config import MaskConfig, TrainConfig
from htr_vt_tpu.models import masking as jmasking
from htr_vt_torch.models import masking
from htr_vt_torch.train.step import TRI_MASK_MODES
from test_torch_port_memory_levers import (check_against_jax, jax_init, jax_step, port_step,
                                           tiny_cfg)
from test_torch_port_sgm import ALPHABET, LMAX, SGM, _sgm_arrays, _texts
from test_torch_port_zoo import no_dropout

B, N, G = 4, 16, 2


def sgm_batch(seed):
    """``test_torch_port_sgm._batch`` at 64x64 px."""
    rng = np.random.default_rng(seed)
    texts = _texts(rng, B)
    labels = np.zeros((B, LMAX), np.int32)
    for i, t in enumerate(texts):
        labels[i, :len(t)] = [ALPHABET.index(c) + 1 for c in t]
    return {"image": rng.random((B, 64, 64, 1), dtype=np.float32), "labels": labels,
            "label_lengths": np.array([len(t) for t in texts], np.int32),
            **_sgm_arrays(texts)}


def test_grad_accum_tri_masked_sgm_step_matches_jax(monkeypatch):
    cfg = tiny_cfg(TrainConfig(total_iters=100, tri_masked=True, grad_accum=G),
                   sgm=dataclasses.replace(SGM, warmup_iters=0))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, nb_cls=len(ALPHABET) + 1, masking=MaskConfig(mode="mms", ratio=0.3)))
    rng = np.random.default_rng(9)
    masks = {mode: (rng.random((B // G, N, 1)) > ratio).astype(np.float32)
             for mode, ratio in TRI_MASK_MODES}
    batch = sgm_batch(31)
    init = jax_init(cfg, 3, batch)
    monkeypatch.setattr(jmasking, "build_keep_mask",
                        lambda *a, mode=None, ratio=None: jnp.asarray(masks[mode]))
    draws = []

    def port_mask(*a, mode=None, ratio=None):
        draws.append(mode)
        return torch.from_numpy(masks[mode])

    monkeypatch.setattr(masking, "build_keep_mask", port_mask)
    with no_dropout():
        want, state = jax_step(cfg, init, batch)
        got, port = port_step(cfg, init, batch)
    modes = [mode for mode, _ in TRI_MASK_MODES]
    assert draws == modes * G * 2  # three forwards a microbatch, two passes
    assert "sgm_head" in state.params and port.model.sgm_head is not None
    check_against_jax(got, port, want, state)
