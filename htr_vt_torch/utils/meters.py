"""Small metric accumulators.

API-parity with the reference's utils (model_v1/utils/utils.py): ``Averager``
(:89-107, running mean over element counts) and ``DistributedMetric``
(:110-125 ``Metric`` — all-reduce averaged scalar; in the reference it is
dead code because nothing initializes torch.distributed; here it works over
any jax array by reading the globally-reduced value jit already produced).

The port's own copy of ``htr_vt_tpu/utils/meters.py``, held to it by
``tests/test_torch_port_loop.py``.
"""

from __future__ import annotations

import numpy as np


class Averager:
    def __init__(self):
        self.reset()

    def add(self, value) -> None:
        arr = np.asarray(value)
        self.sum += float(arr.sum())
        self.n_count += int(arr.size)

    def reset(self) -> None:
        self.sum = 0.0
        self.n_count = 0

    def val(self) -> float:
        return self.sum / self.n_count if self.n_count else 0.0


class DistributedMetric:
    """Running mean of already-globally-reduced scalars. Under jit over a
    batch-sharded mesh every scalar metric is already the global value, so
    update() just accumulates (the reference's dist.all_reduce is implicit)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.sum = 0.0
        self.n = 0

    def update(self, value) -> None:
        self.sum += float(value)
        self.n += 1

    @property
    def avg(self) -> float:
        return self.sum / self.n if self.n else 0.0
