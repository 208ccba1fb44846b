"""The port's training slice vs the JAX reference, on the CPU at a tiny
float32 config: the schedule, EMA decay, SAM perturbation and span masks;
the train-mode forward (batch-statistic BN, injected keep mask); and three
full SAM + AdamW + EMA train steps from the same weights, batches and keep
masks. The JAX and torch random streams differ, so keep masks are handed to
both sides, and drawn masks are held to the JAX masks' statistics.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import (ExperimentConfig, MaskConfig, ModelConfig,
                               OptimConfig)
from htr_vt_tpu.models import masking as jmasking
from htr_vt_tpu.models import stem as jstem
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.optim import ema as jema
from htr_vt_tpu.optim import sam as jsam
from htr_vt_tpu.optim.schedule import warmup_cosine_lr as jax_lr
from htr_vt_tpu.train.state import TrainState as JaxTrainState
from htr_vt_tpu.train.step import jit_train_step
from htr_vt_torch.eval.validate import validate
from htr_vt_torch.models import masking
from htr_vt_torch.optim import ema, sam
from htr_vt_torch.optim.schedule import warmup_cosine_lr
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import eval_step, train_step
from htr_vt_torch.utils.convert import load_jax_train_state, model_to_jax_tree
from test_torch_port_model import (BF16, BLOCK_CASES, _bf16, strict_jit,
                                   tiny_jax_weights, tiny_port_model)

# 64x64 px -> 16 tokens; stem widths 8/16/32.
TINY = ModelConfig(nb_cls=8, img_size=(64, 64), embed_dim=32, depth=2,
                   num_heads=2, compute_dtype="float32",
                   masking=MaskConfig(mode="span", ratio=0.4, max_span_length=4))
OPTIM = OptimConfig(max_lr=1e-3, warmup_iters=2, total_iters=12)
CFG = ExperimentConfig(model=TINY, optim=OPTIM)
B, N, LMAX = 4, 16, 9
STEPS = 3
# Train-mode logits: the train-BN bar of
# tests/test_reference_model_parity.py:174 (batch statistics over B=4).
TRAIN_LOGITS_TOL = dict(rtol=1e-3, atol=5e-4)
BN_STATS_TOL = dict(rtol=1e-5, atol=1e-5)


def _batch(seed):
    """Images, labels and lengths as numpy. Row 0 has length 0; row 1 has
    nine equal labels, which need 2 * 9 - 1 = 17 > 16 frames, so no
    alignment exists (zero loss, zero gradient)."""
    rng = np.random.default_rng(seed)
    image = rng.random((B, 64, 64, 1), dtype=np.float32)
    labels = rng.integers(1, TINY.nb_cls, (B, LMAX)).astype(np.int32)
    lengths = np.array([0, LMAX, 3, 5], np.int32)
    labels[1] = labels[1, 0]
    labels[np.arange(LMAX)[None] >= lengths[:, None]] = 0
    return {"image": image, "labels": labels, "label_lengths": lengths}


def _keep(seed):
    """A per-sample keep mask [B, N, 1] float32, about 40% masked."""
    rng = np.random.default_rng(seed)
    return (rng.random((B, N, 1)) > 0.4).astype(np.float32)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# --- (e) schedule, EMA decay, SAM perturbation, span masks ------------------
@pytest.mark.parametrize("step", [0, 1, 5, 999, 1000, 1001, 50_000, 99_999])
def test_warmup_cosine_lr_matches_jax(step):
    kw = dict(max_lr=1e-3, warmup_iters=1000, total_iters=100_000, min_lr=1e-7)
    # JAX evaluates in float32: its phase and cosine round at 1e-7 relative
    np.testing.assert_allclose(warmup_cosine_lr(step, **kw),
                               float(jax_lr(step, **kw)), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n", [0.0, 0.5, 7.0, 1e5])
def test_ema_decay_matches_jax(n):
    np.testing.assert_allclose(ema.ema_decay_at(n, 0.9999),
                               float(jema.ema_decay_at(n, 0.9999)), rtol=1e-6)


@pytest.mark.parametrize("adaptive", [False, True])
def test_sam_perturb_matches_jax(adaptive):
    rng = np.random.default_rng(3)
    shapes = [(3, 4), (5,), (2, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want, want_norm = jsam.sam_perturb([jnp.asarray(p) for p in params],
                                       [jnp.asarray(g) for g in grads],
                                       0.05, adaptive)
    got = [torch.from_numpy(p.copy()) for p in params]
    norm = sam.sam_perturb(got, [torch.from_numpy(g) for g in grads], 0.05,
                           adaptive)
    np.testing.assert_allclose(norm.item(), float(want_norm), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_ema_update_covers_params_and_bn_stats():
    model = create_train_state(CFG, "cpu", torch.Generator().manual_seed(0)).model
    ema_model = copy.deepcopy(model)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.add_(1.0)
    d = ema.ema_decay_at(2.0, 0.9999)
    ema.ema_update(ema_model, model, 2.0, 0.9999)
    new, old = model.state_dict(), ema_model.state_dict()
    for k in ("mask_token", "patch_embed.bn1.running_var", "head.weight"):
        np.testing.assert_allclose(old[k].numpy(),
                                   d * (new[k] - 1.0).numpy() + (1 - d) * new[k].numpy(),
                                   rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ema_model.pos_embed, model.pos_embed, rtol=0, atol=0)


@pytest.mark.parametrize("length,ratio,span", [(128, 0.4, 8), (16, 0.4, 4),
                                               (256, 0.3, 4), (16, 0.1, 4)])
def test_span_mask_statistics_match_jax(length, ratio, span):
    """Batch-shared spans of ``span`` tokens, at most int(L * ratio) // span
    of them, starts in [0, L - span) (so the last token is never masked),
    and the JAX masks' coverage, overall and per position."""
    gen = torch.Generator().manual_seed(0)
    num_spans = int(length * ratio) // span
    draws = 400
    got = np.stack([masking.span_mask(gen, 3, length, ratio, span).numpy()
                    for _ in range(draws)])
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    want = np.stack([np.asarray(jmasking.span_mask(k, 3, length, ratio, span))
                     for k in keys])
    assert got.shape == want.shape == (draws, 3, length, 1)
    assert (got == got[:, :1]).all()  # shared by the batch
    masked = 1.0 - got[:, 0, :, 0]
    if num_spans == 0:
        assert masked.sum() == 0 and (1.0 - want).sum() == 0
        return
    assert masked.sum(axis=1).max() <= num_spans * span
    assert masked.sum(axis=1).min() >= span
    assert not masked[:, length - 1].any()  # the last start is L - span - 1
    np.testing.assert_allclose(masked.mean(), (1.0 - want).mean(), atol=0.03)
    np.testing.assert_allclose(masked.mean(axis=0), (1.0 - want[:, 0, :, 0]).mean(axis=0),
                               atol=0.12)


def test_build_keep_mask_modes():
    gen = torch.Generator().manual_seed(0)
    none = masking.build_keep_mask(gen, 2, 16, MaskConfig(mode="none"))
    assert none.shape == (2, 16, 1) and (none == 1).all()
    for mode in ("span_old", "random", "block", "span_spacing", "mms"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            masking.build_keep_mask(gen, 2, 16, MaskConfig(mode=mode))


def test_apply_mask_matches_jax():
    rng = np.random.default_rng(4)
    tokens = rng.standard_normal((2, 16, 8)).astype(np.float32)
    keep = (rng.random((2, 16, 1)) > 0.5).astype(np.float32)
    token = rng.standard_normal((1, 1, 8)).astype(np.float32)
    want = jmasking.apply_mask(jnp.asarray(tokens), jnp.asarray(keep),
                               jnp.asarray(token))
    got = masking.apply_mask(torch.from_numpy(tokens), torch.from_numpy(keep),
                             torch.from_numpy(token))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- (c) the train-mode forward ---------------------------------------------
@pytest.fixture(scope="module")
def weights():
    return tiny_jax_weights(TINY, seed=5)


def _port_state(weights):
    params, stats = weights
    state = create_train_state(CFG, "cpu", torch.Generator().manual_seed(0))
    jax_like = JaxTrainState(step=0, params=params, batch_stats=stats,
                             opt_state=None, ema_params=params,
                             ema_batch_stats=stats, rng=None)
    load_jax_train_state(state.model, state.ema_model, jax_like)
    return state


def test_train_forward_with_injected_keep_matches_jax(weights, monkeypatch):
    params, stats = weights
    batch = _batch(6)
    keep = _keep(7)
    monkeypatch.setattr(jmasking, "build_keep_mask",
                        lambda *a, **k: jnp.asarray(keep))
    want, mutated = jax.jit(lambda v, x: JaxHTRVT(TINY).apply(
        v, x, train=True, use_masking=True, mutable=["batch_stats"],
        rngs={"mask": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}))(
        {"params": params, "batch_stats": stats}, jnp.asarray(batch["image"]))
    model = _port_state(weights).model
    got = model(torch.from_numpy(batch["image"]), train=True,
                keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TRAIN_LOGITS_TOL)
    _, got_stats = model_to_jax_tree(model)
    want_stats = _leaves(jax.tree.map(np.asarray, mutated["batch_stats"]))
    got_stats = _leaves(got_stats)
    assert got_stats.keys() == want_stats.keys()
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, **BN_STATS_TOL, err_msg=k)
    # the eval forward after it: eval BN, no mask, whatever train did
    with torch.inference_mode():
        eval_logits = model(torch.from_numpy(batch["image"]))
    want_eval = JaxHTRVT(TINY).apply(
        {"params": params, "batch_stats": mutated["batch_stats"]},
        jnp.asarray(batch["image"]), train=False)
    np.testing.assert_allclose(eval_logits.numpy(), np.asarray(want_eval),
                               rtol=1e-4, atol=2e-4)


@pytest.fixture(scope="module")
def weights16():
    params, stats = tiny_jax_weights(BF16)
    return params, stats, tiny_port_model(params, stats, BF16)


@pytest.mark.parametrize("stage,block,strides,proj", BLOCK_CASES)
def test_bf16_train_basic_block_matches_jax(weights16, stage, block, strides,
                                            proj):
    """The train dataflow's casts in bf16: each BN output rounded to bf16
    before the ReLU, the residual sum and its ReLU in bf16. The batch
    statistics are float32 sums in another order, so an element may round
    one bf16 ulp apart (measured: at most 0.03% of the elements). The eval
    form's float32 epilogue (BN outputs and residual summed in float32, one
    cast at the end) leaves 14-19% of them unequal."""
    params, stats, model = weights16
    name = f"stage{stage}_block{block + 1}"
    cin = (16, 32, 64)[stage - 1] if block else (16, 16, 32)[stage - 1]
    x = np.random.default_rng(2).standard_normal((4, 8, 12, cin)).astype(np.float32)
    jmod = jstem.BasicBlock((16, 32, 64)[stage - 1], strides,
                            use_projection=proj, dtype=jnp.bfloat16)
    variables = {"params": params["stem"][name],
                 "batch_stats": stats["stem"][name]}
    xj, xt = _bf16(x)
    want, mutated = strict_jit(lambda v, x: jmod.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, xj)
    want = np.asarray(want.astype(jnp.float32))
    tmod = copy.deepcopy(getattr(model.patch_embed, f"layer{stage}")[block])
    with torch.no_grad():
        got = tmod(xt.permute(0, 3, 1, 2), train=True)
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert (got == want).mean() >= 0.99, (got == want).mean()
    # one ulp of the result, or of the operands of a residual sum that cancels
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-6)
    sd = tmod.state_dict()
    for k, w in _leaves(jax.tree.map(np.asarray, mutated["batch_stats"])).items():
        bn, stat = k.split("/")
        port_bn = {"bn1": "bn1", "bn2": "bn2", "proj_bn": "downsample.1"}[bn]
        port_stat = {"mean": "running_mean", "var": "running_var"}[stat]
        np.testing.assert_allclose(sd[f"{port_bn}.{port_stat}"].numpy(), w,
                                   **BN_STATS_TOL, err_msg=k)


def test_keep_mask_only_in_train_mode(weights):
    model = _port_state(weights).model
    x = torch.zeros((1, 64, 64, 1))
    with pytest.raises(ValueError, match="train mode"):
        model(x, keep=torch.ones((1, N, 1)))


def test_train_forward_draws_batch_shared_spans(weights):
    """Without an injected mask, train mode draws span masks from the
    generator; with masking off it equals the unmasked train forward."""
    model = _port_state(weights).model
    x = torch.from_numpy(_batch(8)["image"])
    gen = torch.Generator().manual_seed(1)
    drawn = model(x, train=True, generator=gen)
    ones = model(x, train=True, keep=torch.ones((B, N, 1)))
    assert drawn.shape == ones.shape == (B, N, TINY.nb_cls)
    assert not torch.allclose(drawn, ones)
    off = dataclasses.replace(TINY, masking=MaskConfig(mode="none"))
    model.cfg = off
    torch.testing.assert_close(model(x, train=True), ones, rtol=1e-6, atol=1e-6)


# --- (d) three SAM train steps -----------------------------------------------
@pytest.fixture(scope="module")
def trajectories(weights):
    """The same three SAM steps on both stacks: same weights, batches and
    keep masks (pass 1 and pass 2 of every step get masks A and B)."""
    params, stats = weights
    masks = [_keep(20), _keep(21)]
    batches = [_batch(30 + i) for i in range(STEPS)]
    calls = []

    def jax_mask(*args, **kwargs):
        calls.append(len(calls))
        return jnp.asarray(masks[(len(calls) - 1) % 2])

    orig = jmasking.build_keep_mask
    jmasking.build_keep_mask = jax_mask
    try:
        from htr_vt_tpu.optim.sam import make_base_optimizer
        tx = make_base_optimizer(OPTIM)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=tx.init(params),
            ema_params=jax.tree.map(jnp.copy, params),
            ema_batch_stats=jax.tree.map(jnp.copy, stats),
            rng=jax.random.PRNGKey(0))
        step_fn = jit_train_step(JaxHTRVT(TINY), CFG, donate=False)
        jax_metrics = []
        for b in batches:
            state, m = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()})
            jax_metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jmasking.build_keep_mask = orig
    assert len(calls) == 2  # traced once: pass 1 -> A, pass 2 -> B

    port = _port_state(weights)
    port_masks = iter([torch.from_numpy(masks[i % 2]) for i in range(2 * STEPS)])
    orig = masking.build_keep_mask
    masking.build_keep_mask = lambda *a, **k: next(port_masks)
    try:
        port_metrics = [{k: float(v) for k, v in train_step(port, b).items()}
                        for b in batches]
    finally:
        masking.build_keep_mask = orig
    return jax_metrics, state, port_metrics, port


def _lr_sum():
    return sum(warmup_cosine_lr(i, max_lr=OPTIM.max_lr,
                                warmup_iters=OPTIM.warmup_iters,
                                total_iters=OPTIM.total_iters,
                                min_lr=OPTIM.min_lr) for i in range(STEPS))


def _check_trajectory(got, want, what):
    """After three steps every leaf agrees within 1% of the summed LR (the
    most three Adam steps can move an element), save the key third of each
    qkv bias. Its gradient is zero in exact arithmetic (softmax ignores a
    per-row constant), so each stack's rounding noise sets its sign, and
    Adam, which normalises the gradient, moves it by up to the LR either
    way: held to the noise bound of tests/test_reference_model_parity.py
    (3 x the summed LR) alone."""
    lr_sum = _lr_sum()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k.endswith("attn/qkv/bias"):
            q_b, k_b, v_b = np.split(np.abs(g - w), 3)
            assert k_b.max() < 3.0 * lr_sum, (what, k, k_b.max())
            g, w = np.concatenate([g[:len(q_b)], g[-len(v_b):]]), \
                np.concatenate([w[:len(q_b)], w[-len(v_b):]])
        diff = np.abs(g - w)
        assert diff.max() < 0.01 * lr_sum, (what, k, diff.max() / lr_sum)


def test_train_step_losses_and_grad_norm_match_jax(trajectories):
    jax_metrics, _, port_metrics, port = trajectories
    assert port.step == STEPS
    for key in ("loss", "loss_second", "grad_norm"):
        got = [m[key] for m in port_metrics]
        want = [m[key] for m in jax_metrics]
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=key)
    assert port_metrics[0]["loss"] > 0 and np.isfinite(
        [v for m in port_metrics for v in m.values()]).all()


def test_train_step_params_match_jax(trajectories):
    _, state, _, port = trajectories
    got, _ = model_to_jax_tree(port.model)
    _check_trajectory(_leaves(got), _leaves(jax.tree.map(np.asarray, state.params)),
                      "params")


def test_train_step_bn_stats_match_jax(trajectories):
    """Both stacks track flax's biased running variance; after three steps
    (six train forwards) the stats agree to the forwards' own noise."""
    _, state, _, port = trajectories
    _, got = model_to_jax_tree(port.model)
    want = _leaves(jax.tree.map(np.asarray, state.batch_stats))
    got = _leaves(got)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-4, err_msg=k)


def test_train_step_ema_matches_jax(trajectories):
    _, state, _, port = trajectories
    got_p, got_s = model_to_jax_tree(port.ema_model)
    _check_trajectory(_leaves(got_p),
                      _leaves(jax.tree.map(np.asarray, state.ema_params)), "EMA")
    want_s = _leaves(jax.tree.map(np.asarray, state.ema_batch_stats))
    for k, w in _leaves(got_s).items():
        np.testing.assert_allclose(w, want_s[k], rtol=1e-3, atol=1e-4, err_msg=k)


def test_validate_averages_valid_rows_with_the_ema_model(trajectories):
    """Validation over padded batches: only the first num_valid rows count
    toward the loss and the metrics."""
    from htr_vt_tpu.text.converter import CTCLabelConverter
    _, _, _, port = trajectories
    converter = CTCLabelConverter(list("abcdefg"))
    b1, b2 = _batch(40), _batch(41)
    text = lambda b, i: "".join(  # noqa: E731
        converter.character[c] for c in b["labels"][i, :b["label_lengths"][i]])
    texts1 = [text(b1, i) for i in range(B)]
    texts2 = [text(b2, i) for i in range(2)]
    loss, cer, wer, preds, labels = validate(
        port.ema_model, [(b1, B, texts1), (b2, 2, texts2)], converter)
    rows = np.concatenate([eval_step(port.ema_model, b1)["loss_per_sample"].numpy(),
                           eval_step(port.ema_model, b2)["loss_per_sample"][:2].numpy()])
    np.testing.assert_allclose(loss, rows.mean(), rtol=1e-6)
    assert len(preds) == len(labels) == B + 2 and labels == texts1 + texts2
    assert 0.0 <= cer and 0.0 <= wer
