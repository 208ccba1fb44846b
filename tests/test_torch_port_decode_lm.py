"""The port's beam search and n-gram LM (``htr_vt_torch/decode/``,
``htr_vt_torch/native/``) against the JAX package's originals, and the
LM-rescored CLIs (``cli/test_with_lm.py``, ``cli/serve.py --arpa``) against
JAX's on converted weights, on the CPU.

The copies give the JAX functions' beams and scores on the same
log-probabilities; an ``.htlm`` written by either package reads back in the
other with the same scores (native and pure-Python scorers); ``lm_train``
writes the same ARPA text and ``lm_compile`` the same model. The port's
auto-compiled ``.htlm`` cache is written through a temporary file and a
rename (JAX's writes in place): an interrupted write leaves no cache."""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from htr_vt_tpu.cli import args as jargs
from htr_vt_tpu.data.loader import build_dataset as jbuild_dataset
from htr_vt_tpu.data.loader import make_converter as jmake_converter
from htr_vt_tpu.decode import beam as jbeam
from htr_vt_tpu.decode import lm as jlm
from htr_vt_tpu.decode import lm_train as jlm_train
from htr_vt_tpu.models.htr_vt import build_model as jbuild_model
from htr_vt_tpu.text.converter import CTCLabelConverter as JaxConverter
from htr_vt_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from htr_vt_tpu.train.state import create_train_state as jcreate_train_state
from htr_vt_torch import CTCLabelConverter
from htr_vt_torch.cli import serve, test_with_lm
from htr_vt_torch.cli.args import args_to_config, build_parser
from htr_vt_torch.config import config_to_dict
from htr_vt_torch.data.loader import build_dataset, make_converter
from htr_vt_torch.decode import beam, lm, lm_compile, lm_train
from htr_vt_torch.native import build as native_build
from htr_vt_torch.train.checkpoint import CheckpointManager
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.utils.convert import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = ["the cat sat", "a dog ran home", "the quick brown fox", "hello world"] * 3
TINY_FLAGS = ["--embed-dim", "64", "--depth", "1", "--num-heads", "2",
              "--img-size", "128", "64", "--compute-dtype", "float32",
              "--synth-eval-size", "8", "--val-bs", "8"]
BEAM = 4


def _logp(seed, t=24, c=8, b=None):
    rng = np.random.default_rng(seed)
    shape = (t, c) if b is None else (b, t, c)
    x = rng.standard_normal(shape).astype(np.float32) * 2.0
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


@pytest.fixture(scope="module")
def word_arpa(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    path = str(d / "word.arpa")
    lm_train.train_ngram_arpa(CORPUS, path, order=3, level="word")
    return path


@pytest.fixture(scope="module")
def char_arpa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lmc") / "char.arpa")
    lm_train.train_ngram_arpa(CORPUS, path, order=3, level="char")
    return path


# --- beams ------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beams_match_jax(seed):
    lp = _logp(seed)
    assert beam.prefix_beam_search(lp, beam_width=BEAM) == \
        jbeam.prefix_beam_search(lp, beam_width=BEAM)
    assert beam.simple_beam_search(lp, beam_width=BEAM) == \
        jbeam.simple_beam_search(lp, beam_width=BEAM)
    batch = _logp(seed, b=3)
    got = beam.prefix_beam_search_batch(batch, beam_width=BEAM)
    want = jbeam.prefix_beam_search_batch(batch, beam_width=BEAM)
    assert [[(list(s), sc) for s, sc in row] for row in got] == \
        [[(list(s), sc) for s, sc in row] for row in want]
    assert beam.simple_beam_search_batch(batch, beam_width=BEAM, top_k_per_frame=BEAM) \
        == jbeam.simple_beam_search_batch(batch, beam_width=BEAM, top_k_per_frame=BEAM)
    assert beam.collapse_sequence([0, 3, 3, 0, 3, 1]) == \
        jbeam.collapse_sequence([0, 3, 3, 0, 3, 1])


def test_lm_fused_beam_matches_jax(char_arpa):
    vocab = ["<sp>" if ch == " " else ch for ch in "abcdefg"]
    lut = np.concatenate([[-1], np.arange(len(vocab))]).astype(np.int32)
    got = beam.prefix_beam_search_batch(
        _logp(5, b=2), beam_width=BEAM, lm=lm.NgramScorer(char_arpa).indexed(vocab),
        lm_weight=0.4, lm_id_of_class=lut)
    want = jbeam.prefix_beam_search_batch(
        _logp(5, b=2), beam_width=BEAM, lm=jlm.NgramScorer(char_arpa).indexed(vocab),
        lm_weight=0.4, lm_id_of_class=lut)
    assert [[(list(s), sc) for s, sc in row] for row in got] == \
        [[(list(s), sc) for s, sc in row] for row in want]


# --- the n-gram LM ----------------------------------------------------------
PROBES = ["the cat sat", "a dog", "hello world", "zzz unseen", "", "the quick brown fox"]


def test_lm_train_writes_the_jax_arpa(tmp_path):
    for level in ("word", "char"):
        ours, theirs = str(tmp_path / f"o_{level}.arpa"), str(tmp_path / f"t_{level}.arpa")
        lm_train.train_ngram_arpa(CORPUS, ours, order=3, level=level)
        jlm_train.train_ngram_arpa(CORPUS, theirs, order=3, level=level)
        with open(ours) as f, open(theirs) as g:
            assert f.read() == g.read()
    assert lm_train.chars_for_lm("a b") == jlm_train.chars_for_lm("a b")


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_scores_and_htlm_cross_packages(word_arpa, tmp_path, monkeypatch, native):
    """The same ARPA scores alike in both packages, and each package reads
    the other's compiled ``.htlm`` to the same scores."""
    if not native:
        monkeypatch.setattr(lm, "load_native", lambda: None)
        monkeypatch.setattr(jlm, "load_native", lambda: None)
    ours = lm.NgramScorer(word_arpa, auto_compile=False)
    theirs = jlm.NgramScorer(word_arpa, auto_compile=False)
    assert (ours._handle is not None) == native
    assert ours.order == theirs.order == 3
    for s in PROBES:
        assert ours.score(s) == theirs.score(s)
    assert ours.score_next(ours.begin(), "the") == theirs.score_next(theirs.begin(), "the")
    ours.save_binary(str(tmp_path / "o.htlm"))
    theirs.save_binary(str(tmp_path / "t.htlm"))
    with open(tmp_path / "o.htlm", "rb") as f, open(tmp_path / "t.htlm", "rb") as g:
        assert f.read(8) == g.read(8) == lm.BINARY_MAGIC
    for s in PROBES:
        want = theirs.score(s)
        assert lm.NgramScorer(str(tmp_path / "t.htlm")).score(s) == pytest.approx(want,
                                                                                  abs=1e-5)
        assert jlm.NgramScorer(str(tmp_path / "o.htlm")).score(s) == pytest.approx(want,
                                                                                   abs=1e-5)
    cands = [("the cat sat", -3.0), ("the cat", -2.0), ("a dog ran", -4.0)]
    assert lm.rescore_candidates(cands, ours, 0.7, 0.3) == \
        jlm.rescore_candidates(cands, theirs, 0.7, 0.3)


def test_lm_compile_writes_a_model_jax_reads(word_arpa, tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "c.htlm")
    monkeypatch.setattr(sys, "argv", ["lm_compile", word_arpa, out, "--verify"])
    lm_compile.main()
    assert "verify OK" in capsys.readouterr().out
    theirs = jlm.NgramScorer(out)
    for s in PROBES:
        assert theirs.score(s) == lm.NgramScorer(word_arpa, auto_compile=False).score(s)


def test_the_htlm_cache_is_written_whole(word_arpa, tmp_path, monkeypatch):
    """The auto-compiled cache appears beside the ARPA file through a
    rename, and a write that fails half way leaves neither a cache nor a
    temporary file behind."""
    arpa = str(tmp_path / "w.arpa")
    with open(word_arpa) as f, open(arpa, "w") as g:
        g.write(f.read())
    scorer = lm.NgramScorer(arpa)
    assert sorted(os.listdir(tmp_path)) == ["w.arpa", "w.arpa.htlm"]
    assert lm.NgramScorer(arpa).score("the cat sat") == scorer.score("the cat sat")
    os.remove(arpa + ".htlm")

    def torn(self, path):
        with open(path, "wb") as f:
            f.write(lm.BINARY_MAGIC)  # the first bytes, then the disk fills
        raise OSError("no space left on device")

    monkeypatch.setattr(lm.NgramScorer, "save_binary", torn)
    assert lm.NgramScorer(arpa).score("the cat sat") == scorer.score("the cat sat")
    assert sorted(os.listdir(tmp_path)) == ["w.arpa"]


def test_native_library_builds_outside_the_package():
    lib = native_build.load_native()
    assert lib is not None  # g++ is on this machine
    assert native_build._LIB_PATH.parent == \
        native_build._NATIVE_DIR.parent.parent / "build" / "htr_vt_torch_native"
    assert not list(native_build._NATIVE_DIR.glob("*.so"))
    for name in ("editdistance.cpp", "ngram_lm.cpp"):
        with open(native_build._NATIVE_DIR / name) as f, \
                open(os.path.join(REPO, "htr_vt_tpu", "native", name)) as g:
            assert f.read() == g.read().replace("htr_vt_tpu", "htr_vt_torch")


# --- the CLIs on converted weights --------------------------------------------
def converted_checkpoints(root):
    """A tiny SYNTH model's checkpoint in each package, the port's holding
    the JAX one's weights and EMA weights converted (``load_jax_params``):
    (JAX best_CER, port best_CER)."""
    jcfg = jargs.args_to_config(jargs.build_parser("t").parse_args(["SYNTH", *TINY_FLAGS]))
    jconv = jmake_converter(jcfg.data, jbuild_dataset(jcfg.data, "train"))
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, nb_cls=jconv.num_classes))
    jstate = jcreate_train_state(jcfg, jbuild_model(jcfg.model), jax.random.PRNGKey(0),
                                 np.zeros((1, 64, 128, 1), np.float32))
    # a distinct EMA, so that a CLI serving the raw weights would show
    ema = jax.tree.map(lambda p: p * 1.1, jstate.params)
    jstate = jstate.replace(ema_params=ema) if hasattr(jstate, "replace") else \
        dataclasses.replace(jstate, ema_params=ema)
    jdir = os.path.join(root, "jax")
    JaxCheckpointManager(jdir).save(jstate, cer=1.0, wer=1.0, best_cer=1.0, best_wer=1.0)
    cfg = args_to_config(build_parser("t").parse_args(["SYNTH", *TINY_FLAGS]))
    conv = make_converter(cfg.data, build_dataset(cfg.data, "train"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, nb_cls=conv.num_classes))
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(0))
    load_jax_params(state.model, jstate.params, jstate.batch_stats)
    load_jax_params(state.ema_model, jstate.ema_params, jstate.ema_batch_stats)
    pdir = os.path.join(root, "port")
    CheckpointManager(pdir).save(state, cer=1.0, wer=1.0, best_cer=1.0, best_wer=1.0,
                                 meta={"config": config_to_dict(cfg)})
    return os.path.join(jdir, "best_CER"), os.path.join(pdir, "best_CER")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return converted_checkpoints(str(tmp_path_factory.mktemp("ckpt")))


@pytest.mark.parametrize("extra", [[], ["--proper-beam"], ["--lm-in-beam", "--lm-weight",
                                                           "0.4"]],
                         ids=["simple", "prefix", "lm_in_beam"])
def test_test_with_lm_matches_jax(checkpoints, word_arpa, char_arpa, tmp_path,
                                  monkeypatch, extra):
    arpa = char_arpa if "--lm-in-beam" in extra else word_arpa
    argv = ["SYNTH", *TINY_FLAGS, "--arpa", arpa, "--beam-width", "3", "--split", "val",
            *extra]
    from htr_vt_tpu.cli import test_with_lm as jtest_with_lm
    monkeypatch.setattr(sys, "argv", ["lm", *argv, "--checkpoint", checkpoints[0],
                                      "--results-out", str(tmp_path / "j.json")])
    jtest_with_lm.main()
    test_with_lm.main([*argv, "--checkpoint", checkpoints[1], "--results-out",
                       str(tmp_path / "t.json"), "--device", "cpu"])
    with open(tmp_path / "j.json") as f, open(tmp_path / "t.json") as g:
        want, got = json.load(f), json.load(g)
    assert got["n_images"] == want["n_images"] == 8
    for key in ("greedy", "lm_best", "candidates", "ground_truth"):
        assert [s[key] for s in got["samples"]] == [s[key] for s in want["samples"]], key
    for key in ("cer", "wer", "greedy_cer", "greedy_wer"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key


def test_beam_lm_texts_match_the_jax_serve_rescoring(word_arpa):
    """``cli/serve.py:beam_lm_texts`` against JAX's serve loop
    (``htr_vt_tpu/cli/serve.py:215-227``) on the same logits."""
    chars = list("abcdefg")
    logits = np.random.default_rng(3).standard_normal((4, 24, 8)).astype(np.float32) * 3
    greedy = ["g0", "g1", "g2", "g3"]
    got = serve.beam_lm_texts(torch.from_numpy(logits), greedy, CTCLabelConverter(chars),
                              lm.NgramScorer(word_arpa), beam_width=BEAM, lm_weight=0.5)
    jconv, scorer = JaxConverter(chars), jlm.NgramScorer(word_arpa)
    want = []
    for lp, g in zip(np.asarray(jax.nn.log_softmax(logits, -1)), greedy):
        beams = jbeam.prefix_beam_search(lp, beam_width=BEAM)
        cands = [("".join(jconv.character[i] for i in seq
                          if 0 < i < len(jconv.character)), s) for seq, s in beams] \
            or [(g, 0.0)]
        want.append(jlm.rescore_candidates(cands, scorer, 0.5)[0][0])
    assert got == want


def test_serve_arpa_matches_jax(checkpoints, word_arpa, tmp_path, monkeypatch):
    """``serve --arpa`` end to end on line images against JAX's serve CLI
    on the converted checkpoint: the same records."""
    from PIL import Image

    from htr_vt_torch.data.synthetic import render_line
    for i, text in enumerate(["the cat", "a dog ran", "hello"]):
        Image.fromarray(render_line(text, 64, 128, np.random.default_rng(i))).save(
            tmp_path / f"l{i}.png")
    flags = ["--arpa", word_arpa, "--beam-width", "3", "--lm-weight", "0.5",
             "--batch-size", "2", "--images", str(tmp_path / "l*.png")]
    from htr_vt_tpu.cli import serve as jserve
    monkeypatch.setattr(sys, "argv", ["serve", "SYNTH", *TINY_FLAGS, *flags,
                                      "--checkpoint", checkpoints[0],
                                      "--out", str(tmp_path / "j.jsonl")])
    jserve.main()
    serve.main(["SYNTH", *flags, "--checkpoint", checkpoints[1], "--device", "cpu",
                "--out", str(tmp_path / "t.jsonl")])
    with open(tmp_path / "j.jsonl") as f, open(tmp_path / "t.jsonl") as g:
        want = [json.loads(x) for x in f]
        got = [json.loads(x) for x in g]
    assert len(got) == 3 and got == want
