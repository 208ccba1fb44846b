"""The encoder-decoder through ``train/loop.py:fit`` on the CPU, at the tiny
SYNTH run of ``tests/test_torch_port_loop.py`` (embed 64, depth 1, 64x128
px, bs 8) with one decoder layer of two heads: the tokenizer's arrays ride
the loader in training and in eval, the EMA eval runs ``eval_step_ed``
with the tokenizer as its codec, "train 2" equals "train 1, resume, train
1" bit for bit, ``load_model`` / ``load_encoder_only`` restore an ED
checkpoint, and the CTC-only entry points refuse an encoder-decoder.
"""

import dataclasses
import json
import os

import pytest
import torch

from htr_vt_torch.cli import infer
from htr_vt_torch.cli import test as cli_test
from htr_vt_torch.train import loop
from htr_vt_torch.train.checkpoint import CheckpointManager
from htr_vt_torch.train.state import create_train_state
from test_torch_port_loop import _assert_same_state, _checkpoints, tiny_experiment
from test_torch_port_model import no_tensorboard  # noqa: F401

ED = dict(model_type="encoder_decoder", decoder_layers=1, decoder_heads=2, max_seq_len=64)
SYNTH_CHARS = 28  # SYNTH's alphabet; the tokenizer adds four specials


def ed_experiment(out_dir, exp_name, total=2, **train):
    cfg = tiny_experiment(out_dir, exp_name, total=total, **train)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **ED))


@pytest.fixture(scope="module")
def ed_runs(tmp_path_factory):
    """"train 2" (an eval and a checkpoint at 2) and "train 1 (eval and
    checkpoint at 1), resume (auto), train 1"."""
    out = tmp_path_factory.mktemp("ed_fit")
    full = loop.fit(ed_experiment(out, "full"), device="cpu")
    first = ed_experiment(out, "split")
    loop.fit(dataclasses.replace(first, train=dataclasses.replace(
        first.train, total_iters=1, eval_iters=1)), device="cpu")
    loop.fit(ed_experiment(out, "split", resume="auto"), device="cpu")
    return str(out), full


def test_fit_trains_and_evaluates_an_encoder_decoder(ed_runs):
    out, result = ed_runs
    run_dir = os.path.join(out, "full")
    meta_path = os.path.join(_checkpoints(run_dir)[2], "meta.json")
    with open(meta_path) as f:
        model_cfg = json.load(f)["config"]["model"]
    assert model_cfg["ed_vocab_size"] == SYNTH_CHARS + 4
    assert model_cfg["model_type"] == "encoder_decoder"
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        vals = [json.loads(line) for line in f if "val/CER" in line]
    assert len(vals) == 1 and vals[0]["val/loss"] > 0
    assert result["best_cer"] == vals[0]["val/CER"]
    payload, _ = CheckpointManager(run_dir).read(run_dir)
    assert {k.split(".")[0] for k in payload["model"]} == {
        "encoder", "embed", "dec0", "final_norm", "lm_head"}


def test_resumed_encoder_decoder_run_is_bit_equal(ed_runs):
    """Model, EMA, AdamW, step and generator after "train 2" and after
    "train 1, resume, train 1" (no CTC and no eval state in the way)."""
    out, _ = ed_runs
    mgr = CheckpointManager(out)
    full = mgr.read(_checkpoints(os.path.join(out, "full"))[2])[0]
    split = mgr.read(_checkpoints(os.path.join(out, "split"))[2])[0]
    _assert_same_state(full, split, "ED resume")


def test_load_model_and_encoder_only_restore_an_encoder_decoder(ed_runs, tmp_path):
    """``load_model`` takes every weight; ``load_encoder_only`` keeps the
    fresh ``embed``, ``final_norm`` and ``lm_head`` and loads the trunk and
    the decoder blocks, as JAX's head keys say."""
    out, _ = ed_runs
    src = _checkpoints(os.path.join(out, "full"))[2]
    saved, _ = CheckpointManager(out).read(src)
    for encoder_only in (False, True):
        name = f"ed_ft{int(encoder_only)}"
        cfg = ed_experiment(tmp_path, name, total=1, load_model=src,
                            load_encoder_only=encoder_only)
        captured = {}

        def capture(state, batch):
            captured.setdefault("model", {k: v.clone()
                                          for k, v in state.model.state_dict().items()})
            return orig(state, batch)

        orig = loop.train_step
        loop.train_step = capture
        try:
            loop.fit(cfg, device="cpu")
        finally:
            loop.train_step = orig
        fresh = create_train_state(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, nb_cls=SYNTH_CHARS + 1, ed_vocab_size=SYNTH_CHARS + 4)),
            "cpu", torch.Generator().manual_seed(cfg.train.seed)).model.state_dict()
        for k, v in captured["model"].items():
            head = k.split(".")[0] in ("embed", "final_norm", "lm_head")
            want = fresh[k] if encoder_only and head else saved["model"][k]
            assert torch.equal(v, want), (name, k)


def test_ctc_entry_points_refuse_an_encoder_decoder(ed_runs):
    """``cli/test.py`` and ``cli/infer.py`` run the CTC ``eval_step``, which
    an encoder-decoder cannot take (JAX's ``cli/test.py`` tries to)."""
    out, _ = ed_runs
    flags = ["SYNTH", "--model-type", "encoder_decoder", "--checkpoint",
             os.path.join(out, "full"), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="encoder_decoder"):
        cli_test.main(flags)
    with pytest.raises(NotImplementedError, match="encoder_decoder"):
        infer.main(flags + ["--image", "unused.png"])
