"""``train_step`` (3 SAM steps) and ``eval_step`` with the image's width
sharded over the model axis, at (1, 2) on the CPU, against the port's one
process, as ``tests/test_torch_port_width_parallel_steps.py`` holds them:
the fused stem with the encoder tensor-parallel (``shard_model``), and the
fully fused stem with the encoder replicated and tensor-parallel.
"""

from test_torch_port_width_parallel_steps import check_switch_sets


def test_fused_train_and_eval_steps_match_one_process(tmp_path):
    check_switch_sets(tmp_path, ("fused_tp", "fully_fused", "fully_fused_tp"))
