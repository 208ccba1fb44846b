"""What the port's exported serving programs hold, and ``cli/export.py``, on
the CPU. With the fused switches the graph holds ``htrvt::pool_bn_relu_fwd``
and ``htrvt::conv3x3_bn_relu_fwd``, at N = 256 ``htrvt::flash_attention_fwd``,
at int8 ``htrvt::conv_int8`` and ``_int_mm`` (on the CPU each op runs its
kernel's plain twin), and each reloaded program is bit-equal to the live
model; the int8 model exports since ``ops/quant.py:weight_cache`` quantizes
the weight in-graph under a trace. The export CLI writes a bundle of a port
checkpoint's EMA weights at the rounded width buckets, calibrates int8, and
its ``--verify`` holds each program to the live model."""

import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from htr_vt_torch.cli import export as cli_export
from htr_vt_torch.cli.args import args_to_config, build_parser
from htr_vt_torch.config import ModelConfig, config_to_dict
from htr_vt_torch.data.loader import build_dataset, make_converter
from htr_vt_torch.deploy import ServingBundle, export_serving
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import quant as q8
from htr_vt_torch.train.checkpoint import CheckpointManager, load_ema_model
from htr_vt_torch.train.state import create_train_state
from test_torch_port_deploy import FUSED, images, live
from test_torch_port_model import TINY

# The switches and widths at which the exported graph must hold each op:
# (config, width, ops that must appear, ops that must not).
GRAPH_CASES = {
    "fused": (dataclasses.replace(TINY, depth=1, **FUSED), 128,
              {"htrvt.pool_bn_relu_fwd", "htrvt.conv3x3_bn_relu_fwd"},
              {"htrvt.flash_attention_fwd", "htrvt.conv_int8"}),
    "stock": (dataclasses.replace(TINY, depth=1), 128, set(),
              {"htrvt.pool_bn_relu_fwd", "htrvt.conv3x3_bn_relu_fwd",
               "htrvt.flash_attention_fwd"}),
    # N = 1024 / 4 = 256 tokens, head_dim 128: the K5f route (an explicit
    # "flash"; "auto" takes it on a CUDA tensor only)
    "flash": (ModelConfig(nb_cls=8, img_size=(64, 1024), embed_dim=256, depth=1,
                          num_heads=2, compute_dtype="float32", attn_impl="flash"),
              1024, {"htrvt.flash_attention_fwd"}, {"htrvt.pool_bn_relu_fwd"}),
    # the flagship's widths (embed 768, stage 1 padded to 256) at depth 1
    "int8": (ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=768, depth=1,
                         num_heads=6, quant="int8"), 128,
             {"htrvt.conv_int8", "aten._int_mm"}, {"htrvt.flash_attention_fwd"}),
}
# The int8 case's forward: 15 Q1 convs; 4 int8 linears a block.
INT8_Q1, INT8_INT_MM = 15, 4
TINY_FLAGS = ["--embed-dim", "64", "--depth", "1", "--num-heads", "2",
              "--img-size", "128", "64", "--compute-dtype", "float32"]


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_exported_graph_holds_the_kernels_ops(case, tmp_path):
    """Each switch set's program holds its ``htrvt::`` ops (and not the
    others), and its reloaded artifact is bit-equal to the live model. The
    int8 case exported only once ``weight_cache`` stopped reading a fake
    tensor's data pointer under the trace."""
    cfg, width, must, must_not = GRAPH_CASES[case]
    gen = torch.Generator().manual_seed(0)
    if cfg.quant == "int8":
        fmodel = build_model(dataclasses.replace(cfg, quant="none"), device="cpu",
                             generator=gen)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(q8.serving_arrays(cfg, fmodel.state_dict()), strict=True)
        q8.calibrate_quant_stats(model, [images(7, width=width)], 1)
    else:
        model = build_model(cfg, device="cpu", generator=gen)
    program = export_serving(model.eval(), 2, (64, width))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    names = {t.rsplit(".", 1)[0] for t in targets}
    assert must <= names and not names & must_not, sorted(names)
    if cfg.quant == "int8":
        assert targets.count("htrvt.conv_int8.default") == INT8_Q1
        assert targets.count("aten._int_mm.default") == INT8_INT_MM
        assert not model.__dict__.get("_quant_weights")  # the trace cached nothing
    path = str(tmp_path / "p.pt2")
    torch.export.save(program, path)
    img = images(8, width=width)
    with torch.no_grad():
        got = torch.export.load(path).module()(torch.from_numpy(img))
    for g, w in zip(got, live(model, img)):
        np.testing.assert_array_equal(g.numpy(), w)


# --- cli/export.py ------------------------------------------------------------
@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A SYNTH checkpoint of the tiny config (seeded weights, saved as a
    training run saves it)."""
    cfg = args_to_config(build_parser("t").parse_args(["SYNTH", *TINY_FLAGS]))
    converter = make_converter(cfg.data, build_dataset(cfg.data, "train"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, nb_cls=converter.num_classes))
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(0))
    run = str(tmp_path_factory.mktemp("run"))
    CheckpointManager(run).save(state, cer=1.0, wer=1.0, best_cer=1.0, best_wer=1.0,
                                meta={"config": config_to_dict(cfg)})
    return os.path.join(run, "best_CER")


def _export(checkpoint, out, *extra):
    cli_export.main(["SYNTH", *TINY_FLAGS, "--checkpoint", checkpoint, "--out", out,
                     "--batch-size", "2", "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def cli_bundle(checkpoint, tmp_path_factory):
    """The float bundle of ``checkpoint`` at buckets 128 and 190 px, and what
    the CLI printed."""
    out = str(tmp_path_factory.mktemp("cli") / "bundle")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _export(checkpoint, out, "--width-buckets", "128,190", "--verify")
    return out, printed.getvalue()


def test_export_cli_writes_a_verified_bundle(cli_bundle, checkpoint):
    out, printed = cli_bundle
    assert printed.count("OK (bit-exact vs live model)") == 2, printed
    bundle = ServingBundle(out)
    assert bundle.widths == [128, 192]  # 190 rounded up to the width stride, 4
    assert sorted(os.listdir(out)) == ["meta.json", "w0128.pt2", "w0192.pt2"]
    assert bundle.meta["device"] == "cpu" and bundle.meta["quant"] == "float"
    assert bundle.meta["checkpoint"] == os.path.abspath(checkpoint)
    assert bundle.meta["charset"][0] == "[blank]" and bundle.batch_size == 2
    assert len(bundle.transcribe(np.ones((3, 64, 192, 1), np.float32))) == 3


def test_export_cli_calibrates_and_verifies_int8(checkpoint, tmp_path, capsys):
    out = str(tmp_path / "bundle")
    _export(checkpoint, out, "--quant", "int8", "--calib-batches", "1", "--val-bs", "2",
            "--synth-eval-size", "2", "--verify")
    assert "verify width 128: OK (bit-exact vs live model)" in capsys.readouterr().out
    bundle = ServingBundle(out)
    assert bundle.meta["quant"] == "int8" and bundle.widths == [128]


def test_export_cli_refuses_an_encoder_decoder(checkpoint, tmp_path):
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        _export(checkpoint, str(tmp_path / "b"), "--model-type", "encoder_decoder")


def test_verify_catches_a_program_that_differs(cli_bundle, checkpoint, capsys):
    """--verify holds the bundle to the live model: the same bundle against
    a model whose head moved fails it."""
    bundle = ServingBundle(cli_bundle[0])
    model = load_ema_model(checkpoint, None, "cpu")
    assert cli_export.verify_bundle(bundle, model, [128])
    with torch.no_grad():
        model.head.bias.add_(torch.linspace(-5.0, 5.0, model.head.bias.numel()))
    assert not cli_export.verify_bundle(bundle, model, [128])
    assert "MISMATCH" in capsys.readouterr().out
