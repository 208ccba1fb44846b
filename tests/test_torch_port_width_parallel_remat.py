"""remat "all" with the image's width sharded over the model axis, at (1, 2)
on the CPU (two ``gloo`` ranks,
``tests/test_torch_port_width_parallel.py:rank_main``), at
``tests/test_parallel.py:_setup``'s tiny config with dropout, drop-path and
random masking on, batches of 8, the stock and the fully fused stem (the
kernels' plain twins here). The stem is one checkpoint
(``models/htr_vt.py``): its backward recomputes it, replaying every halo
exchange and every BN all-reduce inside the backward, in the forward's
order on both ranks, while the running statistics stay put
(``models/remat.py:recomputing``). Held: the ranks under remat "all" give
the bits of the same ranks without remat (metrics, the whole state after
the first and the third step, the eval logits), as one process's remat
step does (``tests/test_torch_port_memory_levers.py``); and ``eval_step`` and three SAM steps against the port's one process
under remat "all" at ``tests/test_torch_port_width_parallel.py``'s bars.
"""

import pytest

from test_torch_port_width_parallel import SWITCHES, tiny_cfg
from test_torch_port_width_parallel_steps import check_configs


@pytest.mark.parametrize("switches", ["stock", "fully_fused"])
def test_remat_all_on_strips_gives_the_plain_bits(tmp_path, switches):
    kw = SWITCHES[switches]
    check_configs(tmp_path, {"plain": tiny_cfg(**kw), "remat": tiny_cfg(remat="all", **kw)},
                  bs=8, compare={"plain": "remat"})
