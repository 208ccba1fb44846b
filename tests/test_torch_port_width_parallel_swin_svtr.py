"""The standalone ``HTRSwin`` and ``SVTR`` with the image's width sharded
over the model axis, at (1, 2) on the CPU (two ``gloo`` ranks,
``tests/test_torch_port_width_parallel.py:rank_main``), against the port's
one process on the whole images, at ``tests/test_parallel.py:_setup``'s
tiny config (64x128 px, float32; Swin at its default d_model 192, SVTR
tiny) with dropout, drop-path and random masking on, batches of 8:
``eval_step`` and three SAM steps. Swin's truncated ResNet18 stem and its
1x1 ``proj`` run on the strip; SVTR's two stride-2 embeds take one left
column each (``models/stem.py:_conv_w2``) and their BNs sum over the mesh;
the tokens are gathered before masking, so the windows, mixing blocks and
merges see the whole map. The bars are
``tests/test_torch_port_width_parallel.py``'s.
"""

import pytest

from test_torch_port_width_parallel import tiny_cfg
from test_torch_port_width_parallel_steps import check_configs


@pytest.mark.parametrize("encoder", ["swin", "svtr"])
def test_swin_and_svtr_on_strips_match_one_process(tmp_path, encoder):
    check_configs(tmp_path, {encoder: tiny_cfg(encoder=encoder)}, bs=8)
