"""The benchmark's own tests: ``python -m pytest htrbench/tests``. Tests
that need the card are marked ``cuda`` and skip inside the fixture
without one."""

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100 this benchmark measures)")
    return torch.device("cuda")
