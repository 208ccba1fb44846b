"""Two data ranks times two model ranks of the port (``mesh_shape=(2, 2)``,
four ``gloo`` processes on the CPU), the image's width sharded over the
model axis, against JAX as ``tests/test_torch_port_width_parallel_jax.py``
holds (1, 2): the first loss against JAX's loss on the image placed
``P("data", None, "model", None)``, the steps against JAX's jitted
``train_step`` on the batch placed by rows, on a (2, 2) mesh of the
conftest's virtual CPU devices.
"""

from test_torch_port_model import no_tensorboard  # noqa: F401
from test_torch_port_width_parallel_jax import check_width_mesh


def test_width_sharded_ranks_match_jax_two_by_two(tmp_path):
    check_width_mesh(tmp_path, (2, 2))
