"""The van stem with the image's width sharded over the model axis, two
``gloo`` ranks at (1, 2) on the CPU, against JAX as
``tests/test_torch_port_width_parallel_jax.py`` holds the flagship:
``_setup``'s tiny config behind the van stem, batches of 8, masking off;
the eval logits and the first loss against JAX's on the image placed
``P("data", None, "model", None)`` (``check_width_forward``).
"""

from test_torch_port_width_parallel_jax import check_width_forward


def test_width_sharded_van_ranks_match_jax(tmp_path):
    check_width_forward(tmp_path, stem="van")
