"""The encoder-decoder against the JAX package, on the CPU at a tiny float32
config (64x128 px, the HTRVT trunk at embed 64, depth 1, two heads; two
decoder layers of two heads; vocabulary 10; ``max_seq_len`` 16): the
copied tokenizer, ``teacher_forcing_loss``, the teacher-forced
``decode_logits`` and full forward, the cached decode against the uncached
one at every position, greedy and beam generation (ids equal to JAX's on
seeded, tie-free weights), the nucleus filter and its draw, and one SAM
step against JAX's ``train_step`` from the same weights and keep mask. The
2-step ``fit`` with an eval and a resume is in
``tests/test_torch_port_ed_fit.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import ExperimentConfig, MaskConfig, ModelConfig
from htr_vt_tpu.models import encoder_decoder as jed
from htr_vt_tpu.models import masking as jmasking
from htr_vt_tpu.models.htr_vt import build_model as jax_build_model
from htr_vt_tpu.optim.sam import make_base_optimizer
from htr_vt_tpu.text.converter import CTCLabelConverter as JaxConverter
from htr_vt_tpu.text.ed_tokenizer import EDTokenizer as JaxTokenizer
from htr_vt_tpu.train import step as jstep
from htr_vt_tpu.train.state import create_train_state as jax_create_train_state
from htr_vt_torch.models import encoder_decoder as ted
from htr_vt_torch.models import masking
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.text.converter import CTCLabelConverter
from htr_vt_torch.text.ed_tokenizer import EDTokenizer
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import eval_step_ed, train_step
from htr_vt_torch.utils.convert import load_jax_params, load_jax_train_state, model_to_jax_tree
from test_torch_port_model import _randomise, port_config
from test_torch_port_sgm import OPTIM, _check_step, jax_adam_mu
from test_torch_port_zoo import _leaves

ED = dict(model_type="encoder_decoder", ed_vocab_size=10, decoder_layers=2,
          decoder_heads=2, max_seq_len=16)
B, N, L = 3, 32, 8
# float32 on both sides: sums in other orders.
TOL = dict(rtol=1e-5, atol=1e-5)
# The cached decode against the uncached one, both the port's: the same
# products over a longer, masked key axis.
CACHE_TOL = dict(rtol=1e-5, atol=1e-6)
# SAM step: the bars of tests/test_torch_port_sgm.py.
STEP_RTOL = 1e-4
BN_STATS_TOL = dict(rtol=1e-3, atol=1e-4)


def ed_config(**kw):
    return ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=1, num_heads=2,
                       compute_dtype="float32",
                       masking=MaskConfig(mode="random", ratio=0.3), **ED, **kw)


def _init(cfg, seed):
    return jax.jit(lambda k: jax_build_model(cfg).init(
        k, jnp.zeros((1, 64, 128, 1)), jnp.zeros((1, L), jnp.int32)))(
        jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def ed_weights():
    """(cfg, JAX module, params, batch_stats, the port's model holding
    them) from a randomised JAX init."""
    cfg = ed_config()
    v = _init(cfg, 3)
    rng = np.random.default_rng(11)
    params, stats = _randomise(v["params"], rng), _randomise(v["batch_stats"], rng)
    model = build_model(port_config(cfg), device="cpu")
    load_jax_params(model, params, stats)
    return cfg, jax_build_model(cfg), params, stats, model


def _variables():
    _, jmodel, params, stats, model = ed_weights()
    return jmodel, {"params": params, "batch_stats": stats}, model


def _images(seed, b=B):
    return np.random.default_rng(seed).random((b, 64, 128, 1), dtype=np.float32)


def _targets(seed, b=B, v=10):
    """<sos>-led teacher-forcing input, its shifted output, pads past a
    random length."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, v, (b, L - 1))
    lengths = rng.integers(1, L, b)
    tin = np.zeros((b, L), np.int32)
    tout = np.zeros((b, L), np.int32)
    for i, n in enumerate(lengths):
        tin[i, 0], tin[i, 1:n + 1] = 1, ids[i, :n]
        tout[i, :n], tout[i, n] = ids[i, :n], 2
    return tin, tout, (lengths + 1).astype(np.int32)


def test_tokenizer_copy_matches_the_jax_tokenizer():
    chars = list("abc de")
    texts = ["ab", "", "c d e", "zzz", "abcdeabcde"]
    t, j = EDTokenizer(chars), JaxTokenizer(chars)
    assert (t.character, t.vocab_size, t.char_to_idx) == (j.character, j.vocab_size,
                                                          j.char_to_idx)
    for max_length in (4, 12):
        for got, want in zip(t.encode_for_training(texts, max_length),
                             j.encode_for_training(texts, max_length)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    ids = np.random.default_rng(0).integers(0, t.vocab_size, (6, 9))
    assert t.decode(ids) == j.decode(ids) == t.decode_batch(ids)
    ft = EDTokenizer.from_ctc_converter(CTCLabelConverter(chars))
    fj = JaxTokenizer.from_ctc_converter(JaxConverter(chars))
    assert ft.character == fj.character


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
def test_teacher_forcing_loss_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    logits = (3.0 * rng.standard_normal((B, L, 10))).astype(np.float32)
    _, tout, _ = _targets(2)
    want = jed.teacher_forcing_loss(jnp.asarray(logits), jnp.asarray(tout),
                                    label_smoothing=smoothing)
    got = ted.teacher_forcing_loss(torch.from_numpy(logits), torch.from_numpy(tout),
                                   label_smoothing=smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    all_pad = ted.teacher_forcing_loss(torch.from_numpy(logits),
                                       torch.zeros((B, L), dtype=torch.int32))
    assert all_pad.item() == 0.0


def test_decode_logits_and_forward_match_jax():
    """Teacher-forced logits from a given memory, and the whole eval
    forward (encode, decode) from the image."""
    jmodel, variables, model = _variables()
    x = _images(3)
    tin, _, _ = _targets(4)
    memory = np.random.default_rng(5).standard_normal((B, N, 64)).astype(np.float32)
    want = jax.jit(lambda v, m, t: jmodel.apply(v, m, t, method=jmodel.decode_logits))(
        variables, memory, tin)
    with torch.inference_mode():
        got = model.decode_logits(torch.from_numpy(memory), torch.from_numpy(tin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jax.jit(lambda v, x, t: jmodel.apply(v, x, t, train=False))(variables, x, tin)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(tin))
        mem = model.encode(torch.from_numpy(x))
    assert got.shape == (B, L, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(mem.numpy(), np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, method=jmodel.encode))(variables, x)), **TOL)


def test_cached_decode_equals_uncached_at_every_position():
    """``decode_one`` position by position on the caches against
    ``decode_logits`` over the whole prefix (JAX's own
    ``test_cached_generation_matches_uncached`` on the port): logits within
    CACHE_TOL and argmax equal at every position; then greedy ``generate``
    (no repetition penalty) equal to the uncached greedy loop."""
    _, _, model = _variables()
    x = torch.from_numpy(_images(6))
    tin, _, _ = _targets(7)
    tin = torch.from_numpy(tin)
    with torch.inference_mode():
        memory = model.encode(x)
        full = model.decode_logits(memory, tin)
        mem_kvs = model.prefill(memory)
        ks, vs = model.new_caches(B, L, x.device)
        for t in range(L):
            step = model.decode_one(tin[:, t], t, mem_kvs, ks, vs)
            torch.testing.assert_close(step, full[:, t], **CACHE_TOL)
            assert torch.equal(step.argmax(-1), full[:, t].argmax(-1))
        cached = ted.generate(model, x, method="greedy", max_len=L,
                              repetition_penalty=1.0)
        tokens = torch.zeros(B, L + 1, dtype=torch.long)
        tokens[:, 0] = 1
        finished = torch.zeros(B, dtype=torch.bool)
        for t in range(L):
            nxt = model.decode_logits(memory, tokens[:, :-1])[:, t].argmax(-1)
            nxt = torch.where(finished, 0, nxt)
            tokens[:, t + 1] = nxt
            finished |= nxt == 2
    assert torch.equal(cached, tokens[:, 1:].int())


@pytest.mark.parametrize("method,kw", [("greedy", dict(repetition_penalty=1.3)),
                                       ("greedy", dict(repetition_penalty=1.0)),
                                       ("beam_search", dict(beam_size=3)),
                                       ("beam_search", dict(beam_size=1))])
def test_generation_ids_match_jax(method, kw):
    """Greedy (with JAX's repetition penalty over the whole token buffer)
    and beam search give JAX's ids on the same weights and images."""
    jmodel, variables, model = _variables()
    x = _images(8, b=4)
    want = jed.generate(jmodel, variables, x, method=method, max_len=10, **kw)
    got = ted.generate(model, torch.from_numpy(x), method=method, max_len=10, **kw)
    assert got.dtype == torch.int32 and got.shape == (4, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("temperature,top_p", [(0.7, 0.9), (1.0, 0.5), (0.3, 0.99)])
def test_nucleus_filter_matches_jax(temperature, top_p, monkeypatch):
    """JAX's first nucleus step (the repetition-penalised, tempered logits
    with everything below the cut at -1e9), caught at its
    ``jax.random.categorical`` call, against ``nucleus_filter`` on the
    port's first-step logits."""
    jmodel, variables, model = _variables()
    x = _images(9, b=4)
    caught = []
    real = jax.random.categorical

    def catch(key, logits, axis=-1):
        caught.append(np.asarray(logits))
        return real(key, logits, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", catch)
    with jax.disable_jit():  # the scan body runs eagerly: its values are concrete
        jed.generate(jmodel, variables, x, method="nucleus", max_len=1,
                     temperature=temperature, top_p=top_p)
    with torch.inference_mode():
        memory = model.encode(torch.from_numpy(x))
        ks, vs = model.new_caches(4, 1, memory.device)
        tokens = torch.tensor([[1, 0]] * 4)
        logit = model.decode_one(tokens[:, 0], 0, model.prefill(memory), ks, vs)
        got = ted.nucleus_filter(ted.apply_repetition_penalty(logit, tokens, 1.3),
                                 temperature, top_p)
    want = caught[-1]
    np.testing.assert_array_equal(got.numpy() == ted.MASKED_LOGIT, want == -1e9)
    kept = want != -1e9
    np.testing.assert_allclose(got.numpy()[kept], want[kept], **TOL)


def test_nucleus_draws_follow_the_filtered_distribution():
    """20000 draws of one row: only ids inside the nucleus, each at its
    filtered softmax probability within 4 standard errors."""
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.2, -1.0, 0.9, 3.0]])
    probs = torch.softmax(ted.nucleus_filter(logits, 0.7, 0.9), -1)[0]
    n = 20000
    draws = ted.nucleus_sample(logits.expand(n, -1), 0.7, 0.9,
                               torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=logits.shape[1]).double() / n
    assert (freq[probs == 0] == 0).all() and (probs == 0).any()
    se = torch.sqrt(probs.double() * (1 - probs.double()) / n)
    assert ((freq - probs.double()).abs() <= 4 * se + 1e-12).all(), (freq, probs)


def test_eval_step_ed_encodes_once_and_gives_jax_results():
    """``eval_step_ed``: JAX's teacher-forced loss and greedy ids (JAX's
    ``eval_step_ed`` encodes twice; in eval mode the encodings agree)."""
    cfg, jmodel, params, stats, model = ed_weights()
    tin, tout, tlen = _targets(10, b=4)
    batch = {"image": _images(11, b=4), "labels": np.zeros((4, 4), np.int32),
             "label_lengths": np.zeros(4, np.int32), "ed_input": tin, "ed_output": tout,
             "ed_lengths": tlen}
    want = jstep.eval_step_ed(jmodel, ExperimentConfig(model=cfg), params, stats,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    got = eval_step_ed(model, batch)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["pred_ids"].numpy(), np.asarray(want["pred_ids"]))


# --- one SAM step against JAX's train_step ------------------------------------
@pytest.fixture(scope="module")
def ed_step():
    """From the same weights, batch and keep mask, one SAM step on both
    stacks (the trunk's span masking patched to one fixed mask)."""
    cfg = ExperimentConfig(model=ed_config(), optim=OPTIM)
    rng = np.random.default_rng(12)
    keep = (rng.random((B, N, 1)) > 0.3).astype(np.float32)
    tin, tout, tlen = _targets(13)
    batch = {"image": _images(14), "labels": np.zeros((B, 4), np.int32),
             "label_lengths": np.zeros(B, np.int32), "ed_input": tin, "ed_output": tout,
             "ed_lengths": tlen}
    model = jax_build_model(cfg.model)
    init = jax_create_train_state(cfg, model, jax.random.PRNGKey(4),
                                  np.zeros((1, 64, 128, 1), np.float32))
    params = _randomise(jax.tree.map(np.asarray, init.params), rng)
    stats = _randomise(jax.tree.map(np.asarray, init.batch_stats), rng)
    init = init.replace(params=params, batch_stats=stats,
                        opt_state=make_base_optimizer(OPTIM).init(params),
                        ema_params=params, ema_batch_stats=stats)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmasking, "build_keep_mask", lambda *a, **k: jnp.asarray(keep))
        mp.setattr(masking, "build_keep_mask", lambda *a, **k: torch.from_numpy(keep))
        state, m = jax.jit(lambda s, b: jstep.train_step(model, cfg, s, b))(
            init, {k: jnp.asarray(v) for k, v in batch.items()})
        port = create_train_state(port_config(cfg), "cpu",
                                  torch.Generator().manual_seed(0))
        load_jax_train_state(port.model, port.ema_model, init)
        got = {k: float(v) for k, v in train_step(port, batch).items()}
    return {k: float(v) for k, v in m.items()}, got, state, port


def test_sam_step_loss_matches_jax(ed_step):
    """loss (pass 1, the teacher-forced cross-entropy), loss_second and
    grad_norm; no CTC term."""
    want, got, _, port = ed_step
    assert port.step == 1 and "loss_sgm" not in got
    for key in ("loss", "loss_second", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=STEP_RTOL, err_msg=key)


def test_sam_step_updates_params_ema_and_bn_stats_as_jax(ed_step):
    """Every parameter of the trunk and the decoder and its EMA within the
    one-step bars of tests/test_torch_port_sgm.py, the trunk's BN
    statistics within its BN bar."""
    _, _, state, port = ed_step
    mu = _leaves(jax.tree.map(np.asarray, jax_adam_mu(state.opt_state)))
    for module, want_p, want_s, what in (
            (port.model, state.params, state.batch_stats, "params"),
            (port.ema_model, state.ema_params, state.ema_batch_stats, "EMA")):
        got_p, got_s = model_to_jax_tree(module)
        assert {"encoder", "embed", "dec0", "dec1", "final_norm", "lm_head"} == set(got_p)
        _check_step(_leaves(got_p), _leaves(jax.tree.map(np.asarray, want_p)), mu, what)
        want_s = _leaves(jax.tree.map(np.asarray, want_s))
        for k, g in _leaves(got_s).items():
            np.testing.assert_allclose(g, want_s[k], **BN_STATS_TOL, err_msg=k)
