"""The standalone ``SVTR`` (the tiny preset) with the image's width sharded
over the model axis, two ``gloo`` ranks at (1, 2) on the CPU, against JAX
as ``tests/test_torch_port_width_parallel_jax.py`` holds the flagship: 64x128
px, float32, batches of 8, masking off, and dropout off on both stacks
(SVTR's combine dropout draws in train mode); the eval logits and the
first loss against JAX's on the image placed ``P("data", None, "model",
None)`` (``check_width_forward``).
"""

from test_torch_port_width_parallel_jax import check_width_forward


def test_width_sharded_svtr_ranks_match_jax(tmp_path):
    check_width_forward(tmp_path, dropout=False, encoder="svtr")
