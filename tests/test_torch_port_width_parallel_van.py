"""The VAN stems (van, van2) with the image's width sharded over the model
axis, at (1, 2) on the CPU (two ``gloo`` ranks,
``tests/test_torch_port_width_parallel.py:rank_main``), against the port's
one process on the whole images, at ``tests/test_parallel.py:_setup``'s
tiny config (embed 64, depth 1, two heads, 64x128 px, float32) with dropout,
drop-path and random masking on, batches of 8: ``eval_step`` and three SAM
steps. The truncated ResNet18 stem runs on the strip; the VAN blocks' 5x5
and dilated 7x7 depthwise convs read 2 and 9 neighbour columns of the
quarter-width map (16 columns a strip here), the mixer's 1x9 reads 4, and
every BN of the stem sums over the mesh (``models/van.py``). The bars are
``tests/test_torch_port_width_parallel.py``'s.
"""

import pytest

from test_torch_port_width_parallel import tiny_cfg
from test_torch_port_width_parallel_steps import check_configs


@pytest.mark.parametrize("stem", ["van", "van2"])
def test_van_stems_on_strips_match_one_process(tmp_path, stem):
    check_configs(tmp_path, {stem: tiny_cfg(stem=stem)}, bs=8)
