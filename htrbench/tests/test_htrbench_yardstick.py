"""The yardstick: FLOPs from shapes, the copied length mix, the kernels'
launch plan and bounds, the served-gap arithmetic."""

import numpy as np
import pytest

from htrbench import flops, kernels, lines
from htrbench.manifest import Bench
import torch

from htrbench.reference.serve import greedy_ids, rms_gap, served_gap


def bucket_mix(widths, buckets):
    """{bucket: share of the lines}."""
    owners = lines.route(widths, buckets)
    return {b: owners.count(b) / len(owners) for b in sorted(buckets)}


FLAGSHIP = Bench().cell("iam-train-512").config["model"]
INT8 = Bench().cell("iam-int8-serve-512").config["model"]


def test_forward_is_about_38_gflop_a_line():
    # docs/PERF.md: 38 GFLOP a forward of a 64x512 line, 29.2 TFLOP a step
    f = flops.forward_flops(FLAGSHIP, 512)
    assert f["total"] == pytest.approx(38.0e9, rel=0.01)
    assert 128 * flops.train_step_flops(FLAGSHIP, 512) == pytest.approx(29.2e12, rel=0.01)
    assert flops.tokens(64, 512) == 128 and flops.tokens(64, 2048) == 512


def test_length_mix_equals_the_selftest_mix():
    from htr_vt_torch.data.synthetic import selftest_workload_mix
    buckets = [512, 1024, 2048]
    mine = bucket_mix(lines.mix_widths({"selftest": {"n": 4096, "seed": 0}}), buckets)
    assert mine == selftest_workload_mix(buckets)
    assert [round(100 * mine[b], 1) for b in buckets] == [47.6, 28.7, 23.7]


def test_launch_plan_counts():
    train = kernels.plan(FLAGSHIP, 512, 128, train=True)
    assert {k: len(v) for k, v in train.items()} == {
        "K2": 32, "K3f": 2, "K3b": 2, "K4f": 18, "K4d": 18, "K4w": 18}
    assert "K5f" not in kernels.plan(FLAGSHIP, 512, 128, train=False)
    assert len(kernels.plan(FLAGSHIP, 2048, 128, train=False)["K5f"]) == 4
    q = kernels.plan(INT8, 512, 128, train=False)
    assert len(q["Q1"]) == 15 and "K4f" not in q
    # Q1 at stage 1's conv2 (bf16 + BN in): PERF.md's 0.3125 ms by operations
    assert max(q["Q1"]) == pytest.approx(0.3125e-3, rel=0.01)


def test_mfu_peak_seconds():
    f = flops.forward_flops(FLAGSHIP, 512)["total"]
    assert flops.serve_peak_seconds(FLAGSHIP, 512) == pytest.approx(f / 989e12)
    assert flops.serve_peak_seconds(INT8, 512) < f / 989e12


def test_roofline_silent_without_launches():
    plan = kernels.plan(FLAGSHIP, 512, 128, train=False)
    assert kernels.roofline(("K5f",), [(plan, 1)], {"K5f": 0}, {"K5f": 1.0}) is None
    share = kernels.roofline(("K4f",), [(plan, 2)], {"K4f": 18}, {"K4f": 0.02})
    assert share == pytest.approx(100 * sum(plan["K4f"]) * 2 / 0.02)


def test_served_gap():
    rng = np.random.default_rng(0)
    lg = rng.normal(size=(16, 6))
    ids = greedy_ids(lg)
    assert served_gap(lg, ids) == 0.0
    assert served_gap(lg, [1] * 9) == float("inf")  # 9 repeats need 17 frames
    other = [(ids[0] % 5) + 1] + ids[1:] if ids else [1]
    assert served_gap(lg, other) > 0.0


def test_greedy_ids_collapse_repeats_and_drop_blanks():
    lg = np.full((7, 4), -1.0)
    for t, c in enumerate([0, 2, 2, 0, 2, 3, 3]):
        lg[t, c] = 1.0
    assert greedy_ids(lg) == [2, 2, 3]


def test_rms_gap_is_per_line():
    ref = torch.zeros(2, 3, 4)
    prog = ref.clone()
    prog[1] += 0.5
    assert rms_gap(prog, ref).tolist() == [0.0, 0.5]
