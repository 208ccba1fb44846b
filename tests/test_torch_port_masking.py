"""The port's MMS mask strategies against the JAX ones, by their
properties: the torch and JAX random streams differ, so masks are held
draw by draw to each strategy's rules and, over many draws (the batch rows
of one call, each row an independent draw), to the JAX masks' statistics.
"""

import jax
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import MaskConfig as JaxMaskConfig
from htr_vt_tpu.models import masking as jmasking
from htr_vt_torch.config import MaskConfig
from htr_vt_torch.models import masking

DRAWS = 512  # rows per call
# Mean coverage (masked share) of the port's draws against JAX's: each mean
# is over DRAWS rows, whose spread is at most 0.5 / sqrt(512) = 0.022; the
# bar is about 1.5 of those.
COVERAGE_ATOL = 0.03


def port(fn, *args, seed=0):
    keep = fn(torch.Generator().manual_seed(seed), *args)
    return 1.0 - keep.numpy()[..., 0]  # masked [rows, L]


def jax_masked(fn, *args, seed=0):
    return 1.0 - np.asarray(fn(jax.random.PRNGKey(seed), *args))[..., 0]


def runs(row):
    """(start, length) of each masked run of a 0/1 row."""
    padded = np.concatenate([[0], row.astype(int), [0]])
    edges = np.flatnonzero(np.diff(padded))
    return list(zip(edges[::2], edges[1::2] - edges[::2]))


@pytest.mark.parametrize("length,ratio", [(128, 0.30), (16, 0.30), (256, 0.5), (10, 0.04)])
def test_random_masks_exactly_round_ratio_l(length, ratio):
    got = port(masking.random_mask, DRAWS, length, ratio)
    want = jax_masked(jmasking.random_mask, DRAWS, length, ratio)
    num = int(round(ratio * length))
    assert (got.sum(1) == num).all() and (want.sum(1) == num).all()
    # every position equally likely: per-position frequency near num / L
    assert abs(got.mean(0) - num / length).max() < 5 * np.sqrt(0.25 / DRAWS)


@pytest.mark.parametrize("length,ratio", [(128, 0.20), (32, 0.20), (256, 0.2), (512, 0.4)])
def test_block_coverage_reaches_its_target_within_48_placements(length, ratio):
    """Every row reaches round(ratio * L) within the 48 placements and
    overshoots by at most min_block - 1, as JAX's rows do; mean coverage
    and run count as JAX's."""
    got = port(masking.block_mask, DRAWS, length, ratio)
    want = jax_masked(jmasking.block_mask, DRAWS, length, ratio)
    target = int(round(ratio * length))
    for m in (got, want):
        assert (m.sum(1) >= target).all() and (m.sum(1) <= target + 1).all()
    assert abs(got.mean() - want.mean()) < COVERAGE_ATOL
    n_runs = [np.mean([len(runs(r)) for r in m]) for m in (got, want)]
    assert abs(n_runs[0] - n_runs[1]) < 0.15 * n_runs[1]


def _spacing_holds(row, max_span, k):
    """Each run is one accepted span (<= max_span) and the gap between two
    runs is at least the spacing the later span asked for: k = its length
    (ratio <= 0.4), 1 (<= 0.7); at k = 0 spans may touch, so only the
    coverage is held."""
    rs = runs(row)
    if k == 0:
        return True
    for (s0, l0), (s1, l1) in zip(rs, rs[1:]):
        gap = s1 - (s0 + l0)
        if gap < (min(l0, l1) if k == "s" else 1):
            return False
    return all(n <= max_span for _, n in rs)


@pytest.mark.parametrize("length,ratio,k", [(128, 0.4, "s"), (128, 0.2, "s"),
                                            (256, 0.6, 1), (64, 0.8, 0)])
def test_span_spacing_keeps_its_spacing_rule(length, ratio, k):
    """k = s at ratio <= 0.4, 1 at <= 0.7, else 0 (``masking.py:122-169``),
    on every row of both; coverage at most the target plus one span, and
    mean coverage as JAX's."""
    span = 8
    got = port(masking.span_spacing_mask, DRAWS, length, ratio, span)
    want = jax_masked(jmasking.span_spacing_mask, DRAWS, length, ratio, span)
    target = int(round(ratio * length))
    for m in (got, want):
        assert all(_spacing_holds(r, span, k) for r in m)
        assert (m.sum(1) <= target + span - 1).all()
    assert abs(got.mean() - want.mean()) < COVERAGE_ATOL


def test_span_spacing_early_exit_gives_the_full_budget_masks():
    """The host checks coverage every SPAN_CHECK_EVERY attempts and stops
    once every row is covered. On the CPU's sequential generator one chunk
    of the whole budget draws the same stream, so the masks must equal
    that run's bit for bit: the attempts after full coverage change
    nothing."""
    draws = []
    orig_rand, orig_every = torch.rand, masking.SPAN_CHECK_EVERY

    def counted(*args, **kwargs):
        draws.append(args[0])
        return orig_rand(*args, **kwargs)

    try:
        masking.torch.rand = counted
        short = port(masking.span_spacing_mask, 64, 128, 0.2, 8, seed=3)
        assert len(draws) < masking.span_placements(128) // orig_every  # it exited
        masking.SPAN_CHECK_EVERY = masking.span_placements(128)  # one chunk, no exit
        full = port(masking.span_spacing_mask, 64, 128, 0.2, 8, seed=3)
    finally:
        masking.torch.rand, masking.SPAN_CHECK_EVERY = orig_rand, orig_every
    np.testing.assert_array_equal(short, full)
    assert (short.sum(1) >= int(round(0.2 * 128))).all()


@pytest.mark.parametrize("length,ratio,span", [(128, 0.2, 4), (16, 0.4, 4), (64, 0.3, 8)])
def test_span_old_starts_over_the_inclusive_range(length, ratio, span):
    """Batch-shared spans of exactly ``span`` tokens, int(L * ratio) //
    span of them, starts in [0, L - span] inclusive: the last token can be
    masked (``span`` never masks it); per-position frequency as JAX's."""
    gen = torch.Generator().manual_seed(0)
    got = np.stack([1.0 - masking.span_old_mask(gen, 2, length, ratio, span).numpy()[..., 0]
                    for _ in range(400)])
    keys = jax.random.split(jax.random.PRNGKey(0), 400)
    want = np.stack([1.0 - np.asarray(jmasking.span_old_mask(k, 2, length, ratio, span))[
        ..., 0] for k in keys])
    assert (got[:, 0] == got[:, 1]).all()
    num = int(length * ratio) // span
    for m in (got[:, 0], want[:, 0]):
        assert (m.sum(1) <= num * span).all() and (m.sum(1) >= span).all()
        assert m[:, -1].any()  # a start at L - span
    np.testing.assert_allclose(got[:, 0].mean(0), want[:, 0].mean(0), atol=0.12)


def test_mms_is_the_union_of_its_three_masks():
    """``mms``: random, block and spaced-span masks at the MMS sub-ratios,
    multiplied; drawn in that order from one generator."""
    cfg = MaskConfig(mode="mms", max_span_length=8)
    gen = torch.Generator().manual_seed(5)
    got = masking.build_keep_mask(gen, DRAWS, 128, cfg)
    gen = torch.Generator().manual_seed(5)
    parts = (masking.random_mask(gen, DRAWS, 128, cfg.mms_random_ratio)
             * masking.block_mask(gen, DRAWS, 128, cfg.mms_block_ratio)
             * masking.span_spacing_mask(gen, DRAWS, 128, cfg.mms_span_ratio, 8))
    assert torch.equal(got, parts)
    want = 1.0 - np.asarray(jmasking.build_keep_mask(
        jax.random.PRNGKey(5), DRAWS, 128, JaxMaskConfig(mode="mms", max_span_length=8)))
    masked = 1.0 - got.numpy()
    assert (masked.sum((1, 2)) >= round(0.3 * 128)).all()
    assert abs(masked.mean() - want.mean()) < COVERAGE_ATOL


@pytest.mark.parametrize("mode,ratio", [("random", 0.3), ("block", 0.2), ("span_old", 0.2),
                                        ("span_spacing", 0.4)])
def test_masks_draw_on_the_generators_device_and_override_the_config(mode, ratio):
    """``build_keep_mask`` with the tri-masked trainer's (mode, ratio)
    overrides: float32 [B, L, 1] on the generator's device, the config's
    own mode ignored; the same seed gives the same mask."""
    cfg = MaskConfig(mode="span", ratio=0.9, max_span_length=4)
    a = masking.build_keep_mask(torch.Generator().manual_seed(1), 4, 64, cfg, mode, ratio)
    b = masking.build_keep_mask(torch.Generator().manual_seed(1), 4, 64, cfg, mode, ratio)
    assert a.shape == (4, 64, 1) and a.dtype == torch.float32 and a.device.type == "cpu"
    assert torch.equal(a, b)
    assert (1 - a).sum() <= 4 * (round(ratio * 64) + 4)
