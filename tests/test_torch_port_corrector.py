"""The masked-LM word corrector (``htr_vt_torch/decode/lm.py:RobertaCorrector``)
and ``cli/infer.py --llm-correct`` against the JAX package's, on the CPU.

No download: as ``tests/test_roberta_corrector.py`` does, a tiny
``RobertaForMaskedLM`` with seeded random weights and a byte-level BPE
tokenizer trained on a toy corpus are saved locally and loaded through the
``from_pretrained`` path the corrector uses. Both packages' correctors give
the same pseudo-log-likelihoods, rankings and corrections, and the two
infer CLIs print the same lines on converted weights."""

import os
import sys

import pytest

transformers = pytest.importorskip("transformers")

from htr_vt_tpu.decode.lm import RobertaCorrector as JaxCorrector  # noqa: E402
from htr_vt_torch.cli import infer  # noqa: E402
from htr_vt_torch.decode.lm import RobertaCorrector  # noqa: E402
from test_torch_port_decode_lm import TINY_FLAGS, converted_checkpoints  # noqa: E402

TEXTS = ["hello world", "hxllo wxrld", "the quick fox", "handwritten text lines"]
VOCAB = {"hello", "world", "the", "quick", "brown", "fox"}


@pytest.fixture(scope="module")
def tiny_roberta_dir(tmp_path_factory):
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    d = str(tmp_path_factory.mktemp("tiny_roberta"))
    from tokenizers import ByteLevelBPETokenizer
    corpus = ["hello world some words here", "the quick brown fox",
              "handwritten text recognition lines"] * 20
    bpe = ByteLevelBPETokenizer()
    bpe.train_from_iterator(corpus, vocab_size=400, min_frequency=1,
                            special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    bpe.save_model(d)
    from transformers import RobertaConfig, RobertaForMaskedLM, RobertaTokenizerFast
    tok = RobertaTokenizerFast.from_pretrained(d, model_max_length=64)
    tok.save_pretrained(d)
    cfg = RobertaConfig(vocab_size=tok.vocab_size, hidden_size=32, num_hidden_layers=1,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=66, type_vocab_size=1)
    import torch
    torch.manual_seed(0)
    RobertaForMaskedLM(cfg).save_pretrained(d)
    return d


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return converted_checkpoints(str(tmp_path_factory.mktemp("ckpt")))


@pytest.mark.parametrize("threshold", [0.8, 0.0])
def test_corrector_matches_jax(tiny_roberta_dir, threshold):
    """Threshold 0.0 takes every masked fill, so the replacement path runs
    too (the random model is never confident at 0.8)."""
    ours = RobertaCorrector(tiny_roberta_dir, confidence_threshold=threshold)
    theirs = JaxCorrector(tiny_roberta_dir, confidence_threshold=threshold)
    for text in TEXTS:
        assert ours.pseudo_log_likelihood(text) == theirs.pseudo_log_likelihood(text)
        assert ours.correct(text, VOCAB) == theirs.correct(text, VOCAB)
    assert ours.rescore(TEXTS) == theirs.rescore(TEXTS)
    assert ours.correct("hxllo", None) == "hxllo"
    if threshold == 0.0:
        assert any(ours.correct(t, VOCAB) != t for t in TEXTS)


def test_infer_llm_correct_matches_jax(tiny_roberta_dir, checkpoints, tmp_path,
                                      monkeypatch, capsys):
    from PIL import Image

    from htr_vt_torch.data.synthetic import render_line
    image = str(tmp_path / "line.png")
    Image.fromarray(render_line("hello world", 64, 200)).save(image)
    jckpt, ckpt = checkpoints
    argv = ["SYNTH", *TINY_FLAGS, "--image", image, "--llm-correct", tiny_roberta_dir]
    from htr_vt_tpu.cli import infer as jinfer
    monkeypatch.setattr(sys, "argv", ["infer", *argv, "--checkpoint", jckpt])
    jinfer.main()
    want = capsys.readouterr().out.splitlines()
    infer.main([*argv, "--checkpoint", ckpt, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert [ln.split("]")[0] for ln in got] == ["[raw", "[raw+llm"]
    assert got == want


def test_infer_without_the_model_says_so(checkpoints, tmp_path, capsys):
    """Without local weights the corrector is unavailable: infer says so
    and prints the uncorrected line, as JAX's does."""
    from PIL import Image

    from htr_vt_torch.data.synthetic import render_line
    image = str(tmp_path / "line.png")
    Image.fromarray(render_line("hello", 64, 200)).save(image)
    ckpt = checkpoints[1]
    infer.main(["SYNTH", *TINY_FLAGS, "--image", image, "--checkpoint", ckpt,
                "--llm-correct", str(tmp_path / "no_such_model"), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("(LLM correction unavailable:")
    assert [ln.split("]")[0] for ln in lines[1:]] == ["[raw"]
