"""remat on the recipes whose forward moves state inside the wrapped
modules, against the JAX package (CPU, tiny float32, the config of
``tests/test_remat_accum.py``): the conformer under ``"all"`` (JAX's own
remat case, ``test_remat_conformer_sgm_smoke``: the stem's BatchNorms are
recomputed) and macaron under ``"blocks"``, whose ``ConvLocalMixer1D``
blocks carry a ``TokenBatchNorm``, so a recompute of a block would move its
running statistics a second time. Dropout is the identity on both stacks
for the JAX comparison (the streams differ); the port's own remat step is
held bit for bit to its plain step with dropout on.
"""

import dataclasses

import pytest
import torch

from htr_vt_torch.models import remat
from test_torch_port_memory_levers import (assert_same_state, check_against_jax, jax_init,
                                           jax_step, port_step, seeded_steps, tiny_batch,
                                           tiny_cfg)
from test_torch_port_zoo import no_dropout

CASES = [("conformer", "all"), ("macaron", "blocks")]


@pytest.mark.parametrize("encoder,mode", CASES)
def test_remat_recipe_step_matches_jax(encoder, mode):
    cfg = tiny_cfg(encoder=encoder, remat=mode)
    batch = tiny_batch(4, 4)
    init = jax_init(cfg, 1, batch)
    with no_dropout():
        want, state = jax_step(cfg, init, batch)
        got, port = port_step(cfg, init, batch)
        plain, plain_port = port_step(tiny_cfg(encoder=encoder), init, batch)
    check_against_jax(got, port, want, state)
    assert got == plain
    assert_same_state(port, plain_port, (encoder, mode))


@pytest.mark.parametrize("encoder", ["conformer", "macaron"])
@pytest.mark.parametrize("mode", ["blocks", "all"])
def test_remat_moves_running_statistics_once(encoder, mode, monkeypatch):
    """Two steps with dropout on: the remat steps give the plain steps'
    bits, running statistics included (each BatchNorm moved once a
    forward). With the recompute moving them as well, exactly the running
    statistics inside the wrapped modules differ: the stem's under "all",
    macaron's mixers' under either mode (the conformer's blocks hold
    none)."""
    cfg = tiny_cfg(encoder=encoder)
    rcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=mode))
    batches = [tiny_batch(5, 4), tiny_batch(6, 4)]
    plain, plain_port = seeded_steps(cfg, batches)
    got, port = seeded_steps(rcfg, batches)
    assert got == plain
    assert_same_state(port, plain_port, (encoder, mode))

    monkeypatch.setattr(remat, "recomputing", lambda: False)
    _, twice = seeded_steps(rcfg, batches)
    stats = plain_port.model.state_dict()
    moved = {k for k, v in twice.model.state_dict().items()
             if k.endswith(("running_mean", "running_var")) and not torch.equal(v, stats[k])}
    wrapped = {k for k in stats if k.endswith(("running_mean", "running_var"))
               and (k.startswith("blocks.") or mode == "all" and k.startswith("patch_embed."))}
    assert moved == wrapped, sorted(moved ^ wrapped)
    assert wrapped or (encoder, mode) == ("conformer", "blocks")
