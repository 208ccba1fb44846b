"""``train_step`` (3 SAM steps) and ``eval_step`` with the image's width
sharded over the model axis, at (1, 2) on the CPU (two ``gloo`` ranks,
``tests/test_torch_port_width_parallel.py:rank_main``), against the port's
one process on the whole images, at ``tests/test_parallel.py:_setup``'s
tiny config with dropout, drop-path and random masking on: the conformer,
whose token BatchNorm runs after the gather (its sums over the data group
only), and the vit under ``grad_accum`` 2 with remat "blocks". The bars
are ``tests/test_torch_port_width_parallel.py``'s.
"""

import dataclasses

from htr_vt_torch.config import config_to_dict
from test_torch_port_distributed import collect
from test_torch_port_width_parallel import FUSED, SEED, STEPS, start_width, tiny_batch, tiny_cfg
from test_torch_port_width_parallel_steps import check_steps, one_process


def test_conformer_and_accumulation_match_one_process(tmp_path):
    """At (1, 2): the conformer, whose token BatchNorm runs after the
    gather (its sums over the data group only: over the model axis its
    gradient would count twice), and the vit under ``grad_accum`` 2 with
    remat "blocks", each an ``eval_step`` and three steps against one
    process."""
    batches = [tiny_batch(60 + i) for i in range(STEPS)]
    probe = tiny_batch(70)
    cfgs = {"conformer": tiny_cfg(encoder="conformer", **FUSED),
            "accum": dataclasses.replace(tiny_cfg(remat="blocks"), train=dataclasses.replace(
                tiny_cfg().train, grad_accum=2))}
    tasks = {name: dict(kind="steps", cfg=config_to_dict(cfg), seed=SEED + 1,
                        tensor_parallel=False, batches=batches, probe=probe)
             for name, cfg in cfgs.items()}
    procs = start_width(tmp_path, (1, 2), tasks)
    want = {name: one_process(cfg, SEED + 1, batches, probe) for name, cfg in cfgs.items()}
    ranks = collect(procs, tmp_path)
    for name, cfg in cfgs.items():
        assert ranks[1][name]["metrics"] == ranks[0][name]["metrics"]
        check_steps(ranks[0][name], want[name], cfg, name)
