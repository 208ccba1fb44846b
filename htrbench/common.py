"""What the drivers share: the program's configuration from a configuration
file, the port's launch counters, the checks' arithmetic and a run's
outcome."""

from __future__ import annotations

import importlib
import math
import statistics
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from htrbench.kernels import COUNTERS


@dataclass
class Context:
    """One run: the cell, its seed and window, whether it is traced, the
    device, and the process's start on the host clock."""

    cell: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float


@dataclass
class Outcome:
    """What a driver hands back: the work attempted and failed, the
    end-to-end values, the per-layer readers' record, the numbers compared
    with their limits, and the peak of device memory before the check."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    record: dict
    checks: Dict[str, Dict[str, float]]
    memory_peak_bytes: int


def experiment_config(config: dict):
    """The program's ``ExperimentConfig`` with the file's ``model`` and
    ``optim`` fields."""
    from htr_vt_torch.config import ExperimentConfig, MaskConfig, ModelConfig, OptimConfig
    m = dict(config["model"])
    m["masking"] = MaskConfig(**m.get("masking", {}))
    for key in ("img_size", "patch_size"):
        m[key] = tuple(m[key])
    return ExperimentConfig(model=ModelConfig(**m), optim=OptimConfig(**config.get("optim", {})))


SEED_TAGS = {"weights": 1, "data": 2, "masks": 3}


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one use (``SEED_TAGS``) drawn from the run's seed, any
    whole number."""
    state = np.random.SeedSequence([seed % 2**63, SEED_TAGS[tag]]).generate_state(1, np.uint64)
    return int(state[0] % 2**62)


def counters() -> Dict[str, int]:
    """The port's launch counters now, by kernel (``kernels.COUNTERS``)."""
    out = {}
    for k, spec in COUNTERS.items():
        mod, fn = spec.split(":")
        out[k] = getattr(getattr(importlib.import_module(f"htr_vt_torch.ops.{mod}"), fn),
                         "launches", 0)
    return out


def alphabet(classes: int) -> List[str]:
    """Printable characters for the classes after the blank."""
    return [chr(c) for c in range(33, 33 + classes - 1)]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clock() -> float:
    return time.perf_counter()


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keys: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or the median leaf's, whichever
    is larger."""
    keys = list(ref) if keys is None else keys
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def check(value: float, limit: float) -> Dict[str, float]:
    """A number compared and its limit; a number that is not finite (no
    reading, or no alignment) reads as 1e300, past any limit."""
    value = float(value)
    return {"value": value if math.isfinite(value) else 1e300, "limit": limit}
