"""remat "all" with the image's width sharded over the model axis, two
``gloo`` ranks at (1, 2) on the CPU, against JAX as
``tests/test_torch_port_width_parallel_jax.py`` holds the flagship:
``_setup``'s tiny config with the fully fused stem (the kernels' plain
twins; JAX's stock ops, which the switches do not change in value) under
remat "all" on both stacks, batches of 8, masking off; the first loss
against JAX's loss on the image placed ``P("data", None, "model", None)``
at the port's one-step SAM bar, the steps against JAX's jitted, remat
``train_step`` on the batch placed by rows at that file's bars.
"""

from test_torch_port_width_parallel_jax import check_width_mesh


def test_width_sharded_remat_all_ranks_match_jax(tmp_path):
    check_width_mesh(tmp_path, (1, 2), bs=8, remat="all")
