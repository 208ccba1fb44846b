"""The port's command-line entry points on the CPU: the argument bridge
against JAX's for every recipe of tests/test_cli_args.py, the parameter
audit against JAX's, and train -> test -> infer -> serve --checkpoint end
to end on a tiny SYNTH run (``--device cpu``), as tests/test_cli_e2e.py
drives the JAX CLIs."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from htr_vt_tpu.cli import args as jargs
from htr_vt_tpu.cli import params as jparams
from htr_vt_tpu.config import config_to_dict as jconfig_to_dict
from htr_vt_torch.cli import args as targs
from htr_vt_torch.cli import infer, params, serve
from htr_vt_torch.cli import test as cli_test
from htr_vt_torch.cli import train as cli_train
from htr_vt_torch.config import config_to_dict
from htr_vt_torch.train.checkpoint import CheckpointManager, load_ema_model
from htr_vt_torch.train.step import eval_step
from test_torch_port_model import no_tensorboard  # noqa: F401

# Every recipe of tests/test_cli_args.py, and each encoder's preset.
RECIPES = [
    ["IAM", "--max-lr", "1e-3", "--train-bs", "128", "--val-bs", "8",
     "--weight-decay", "0.5", "--mask-ratio", "0.4", "--max-span-length", "8",
     "--img-size", "512", "64", "--total-iter", "100000"],
    ["READ"], ["LAM"], ["SYNTH"],
    ["IAM", "--sgm-enable", "--sgm-detach", "--sgm-lambda", "0.7", "--ctc-lambda", "0.2"],
    ["IAM", "--model-type", "encoder_decoder", "--decoder-layers", "4",
     "--max-seq-len", "128", "--label-smoothing", "0.2"],
    ["IAM", "--proj", "6", "--dila-ero-max-kernel", "2", "--jitter-brightness", "0.3",
     "--no-augment", "--vietnamese-charset", "--tri-masked",
     "--resume", "/x/checkpoint_0.1_0.2_5"],
    ["READ", "--encoder", "conformer", "--mask-mode", "mms"],
] + [["IAM", "--encoder", name] for name in targs.ENCODERS]


@pytest.mark.parametrize("argv", RECIPES, ids=lambda a: "_".join(a)[:40])
def test_args_to_config_gives_the_jax_config(argv):
    got = targs.args_to_config(targs.build_parser("t").parse_args(argv))
    want = jargs.args_to_config(jargs.build_parser("t").parse_args(argv))
    assert config_to_dict(got) == jconfig_to_dict(want)


def test_parser_lists_the_jax_encoders_and_adds_device():
    """JAX's flags, plus ``--device`` and ``--svtr-preset`` (JAX's config
    field, which its parser leaves at the default)."""
    assert targs.available_encoders() == jargs.available_encoders()
    args = targs.build_parser("t").parse_args(["SYNTH"])
    assert args.device == "cuda" and args.svtr_preset == "tiny"
    jflags = {a.dest for a in jargs.build_parser("t")._actions}
    tflags = {a.dest for a in targs.build_parser("t")._actions}
    assert tflags - jflags == {"device", "svtr_preset"} and jflags <= tflags
    cfg = targs.args_to_config(targs.build_parser("t").parse_args(
        ["IAM", "--encoder", "svtr", "--svtr-preset", "small"]))
    assert cfg.model.svtr_preset == "small"


TINY_FLAGS = ["--embed-dim", "64", "--depth", "1", "--num-heads", "2",
              "--img-size", "128", "64", "--compute-dtype", "float32"]


def test_parameter_audit_counts_as_the_jax_one(capsys, monkeypatch):
    params.main(["IAM", *TINY_FLAGS, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["params", "IAM", *TINY_FLAGS])
    jparams.main()
    want = capsys.readouterr().out.splitlines()
    assert got[-1].split()[-1] == want[-1].split()[-1]  # the total
    # grouped by the port's (the reference's) module names
    assert got[0].split()[0] == "patch_embed.layer3"
    assert sum(int(ln.split()[1].replace(",", "")) for ln in got[:-2]) == \
        int(got[-1].split()[-1].replace(",", ""))


@pytest.mark.parametrize("extra", [["--encoder", "swin"], ["--encoder", "svtr"],
                                   ["--encoder", "van"], ["--encoder", "van2"]],
                         ids=["swin", "svtr", "van", "van2"])
def test_parameter_audit_counts_every_model_class_as_the_jax_one(capsys, monkeypatch,
                                                                  extra):
    """The totals of the standalone models and the VAN stems."""
    params.main(["IAM", *TINY_FLAGS, *extra, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["params", "IAM", *TINY_FLAGS, *extra])
    jparams.main()
    want = capsys.readouterr().out.splitlines()
    assert got[-1].split()[-1] == want[-1].split()[-1]


def test_parameter_audit_counts_the_encoder_decoder(capsys):
    """The encoder-decoder at the parser's ``ed_vocab_size`` 0, as the JAX
    audit builds it; JAX's own audit cannot init that model (its embedding
    gather from an empty table raises), so the total is held to a JAX init
    at one token less the one token's embedding row, ``lm_head`` column and
    bias."""
    import jax
    import jax.numpy as jnp

    from htr_vt_tpu.models.htr_vt import build_model as jax_build_model
    extra = ["--model-type", "encoder_decoder", "--decoder-layers", "2", "--max-seq-len",
             "32"]
    params.main(["IAM", *TINY_FLAGS, *extra, "--device", "cpu"])
    got = int(capsys.readouterr().out.splitlines()[-1].split()[-1].replace(",", ""))
    cfg = jargs.args_to_config(jargs.build_parser("t").parse_args(["IAM", *TINY_FLAGS,
                                                                    *extra])).model
    cfg = dataclasses.replace(cfg, ed_vocab_size=1)
    shapes = jax.eval_shape(lambda: jax_build_model(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 1)), jnp.zeros((1, 4), jnp.int32)))
    one_token = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    assert got == one_token - (2 * cfg.embed_dim + 1)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli"))
    cli_train.main(["SYNTH", *TINY_FLAGS, "--exp-name", "e2e", "--out-dir", out,
                    "--train-bs", "8", "--val-bs", "8", "--total-iter", "4",
                    "--eval-iter", "2", "--print-iter", "2", "--warm-up-iter", "1",
                    "--synth-train-size", "16", "--synth-eval-size", "8",
                    "--num-workers", "2", "--device", "cpu"])
    return os.path.join(out, "e2e")


def test_train_writes_its_artifacts(run_dir):
    names = os.listdir(run_dir)
    assert {"run.log", "metrics.jsonl", "best_CER", "best_WER"} <= set(names)
    assert len([n for n in names if n.startswith("checkpoint_")]) == 2  # steps 2, 4


def test_test_writes_per_sample_predictions(run_dir, tmp_path, capsys):
    out = str(tmp_path / "preds.json")
    cli_test.main(["SYNTH", *TINY_FLAGS, "--checkpoint", os.path.join(run_dir, "best_CER"),
                   "--split", "val", "--val-bs", "8", "--synth-eval-size", "8",
                   "--predictions-out", out, "--device", "cpu"])
    with open(out) as f:
        preds = json.load(f)
    assert len(preds["samples"]) == 8 and 0.0 <= preds["CER"]
    assert {"prediction", "label", "cer", "wer"} <= set(preds["samples"][0])
    assert "CER" in capsys.readouterr().out
    # int8 (A8W8) evaluates the run's latest checkpoint after calibrating
    # (tests/test_torch_port_quant_stem.py holds what it computes)
    cli_test.main(["SYNTH", *TINY_FLAGS, "--checkpoint", run_dir, "--quant", "int8",
                   "--calib-batches", "1", "--split", "val", "--val-bs", "8",
                   "--synth-eval-size", "8", "--predictions-out", out, "--device", "cpu"])
    with open(out) as f:
        assert len(json.load(f)["samples"]) == 8


def _line_png(path, seed):
    from PIL import Image

    from htr_vt_torch.data.synthetic import render_line
    Image.fromarray(render_line("hello world", 64, 200, np.random.default_rng(seed))).save(
        path)
    return str(path)


def test_infer_prints_each_variant(run_dir, tmp_path, capsys):
    image = _line_png(tmp_path / "line.png", 0)
    infer.main(["SYNTH", *TINY_FLAGS, "--checkpoint", os.path.join(run_dir, "best_CER"),
                "--image", image, "--binarize-sweep", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("]")[0] for ln in lines if ln.startswith("[")] == \
        ["[raw", "[bin@0.3", "[bin@0.4", "[bin@0.5", "[bin@0.6", "[bin@0.7"]
    # --llm-correct without local weights: said, and the line printed
    # uncorrected (tests/test_torch_port_corrector.py holds the corrector)
    infer.main(["SYNTH", *TINY_FLAGS, "--checkpoint", run_dir, "--image", image,
                "--llm-correct", str(tmp_path / "no_such_model"), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("(LLM correction unavailable:")
    assert [ln.split("]")[0] for ln in lines[1:]] == ["[raw"]


def test_serve_takes_a_training_checkpoint_and_serves_its_ema(run_dir, tmp_path):
    """serve --checkpoint with the run directory (its latest) and with
    best_CER writes one record a line, built at the saved config; the
    served model holds the checkpoint's EMA weights, not the raw ones."""
    images = [_line_png(tmp_path / f"l{i}.png", i) for i in range(3)]
    for ckpt in (run_dir, os.path.join(run_dir, "best_CER")):
        out = str(tmp_path / "serve.jsonl")
        serve.main(["SYNTH", "--checkpoint", ckpt, "--images", str(tmp_path / "l*.png"),
                    "--batch-size", "2", "--out", out, "--device", "cpu"])
        with open(out) as f:
            records = [json.loads(line) for line in f]
        assert [r["image"] for r in records] == images
    payload, _ = CheckpointManager(run_dir).read(run_dir)
    model = serve.load_serving_model(run_dir, None, "cpu")
    assert model.cfg.embed_dim == 64
    for k, v in model.state_dict().items():
        assert torch.equal(v, payload["ema_model"][k]), k
    assert any(not torch.equal(payload["model"][k], payload["ema_model"][k])
               for k in payload["model"])
    again = load_ema_model(run_dir, model.cfg, "cpu")
    batch = {"image": np.random.default_rng(0).random((2, 64, 128, 1), np.float32),
             "labels": np.zeros((2, 4), np.int32), "label_lengths": np.zeros(2, np.int32)}
    assert torch.equal(eval_step(model, batch)["pred_ids"],
                       eval_step(again, batch)["pred_ids"])
