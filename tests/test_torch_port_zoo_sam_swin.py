"""One tri-masked SGM SAM step of HTRSwin (``model_sgm_mms_swin``) against
JAX's ``train_step`` on the CPU, as ``tests/test_torch_port_zoo_sam.py``
holds van and van2 (one model a file: its JAX compile takes most of a
minute)."""

import pytest

from test_torch_port_zoo_sam import check_losses, check_updates, run_sam_step


@pytest.fixture(scope="module")
def sam_step():
    return run_sam_step("swin")


def test_tri_masked_sgm_step_loss_matches_jax(sam_step):
    check_losses(sam_step)


def test_tri_masked_sgm_step_updates_params_ema_and_bn_stats_as_jax(sam_step):
    check_updates(sam_step)
