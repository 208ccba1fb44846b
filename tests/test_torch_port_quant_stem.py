"""int8 serving on the CPU, the parts past the tiny models: the ResNet18 stem
at widths where int8 pays (the s8 entry, the s8 max-pool and the s8 carry),
its ``pool_impl="pallas"`` branch against JAX's interpret-mode K3f, the
flagship with its stage 1 padded to 256, and ``cli/test.py`` /
``cli/infer.py`` at ``--quant int8``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import ModelConfig
from htr_vt_tpu.models import stem as jstem
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.ops import pool_fused as jpf
from htr_vt_tpu.ops import quant as jq
from htr_vt_torch.cli import infer
from htr_vt_torch.cli import test as cli_test
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.models.stem import ResNet18Stem
from htr_vt_torch.ops import quant as q8
from htr_vt_torch.train import loop
from htr_vt_torch.utils.convert import load_jax_params, model_quant_stats, model_to_jax_tree
from test_torch_port_loop import _checkpoints, tiny_experiment
from test_torch_port_model import _randomise, no_tensorboard, port_config  # noqa: F401
from test_torch_port_model import strict_jit

# The stem at embed 1024 (conv1 256 wide) with every stage 256 wide: all
# fifteen block convs int8, the s8 pool and the s8 carry through the six
# blocks; bf16 on a [2, 64, 32, 1] image.
STEM_WIDTHS = (256, 256, 256)
# The port's stem against JAX's, bf16. XLA's rsqrt differs from torch's in
# the last float32 bit for about a third of the BN variances, so the folded
# BN terms differ by an ulp and, through the bf16 epilogues, some
# activations round the other way; in the int8 modes an activation near a
# rounding half also takes the other code. Measured on this input: the
# calibrated abs-maxes equal; the outputs' relative L2 4.9e-3 (calibrate,
# either pool), 2.2e-2 (static, either pool), 2.0e-2 (dynamic). The bars
# are about 2x; the abs-maxes are held to 1e-3.
STEM_AMAX_RTOL = 1e-3
STEM_REL = {"calibrate": 1e-2, "static": 4.5e-2, "dynamic": 4e-2}
# The padded flagship against JAX's on the same padded tree, int8 logits:
# measured 4.2e-2 relative L2 with every frame's argmax equal (each side's
# int8 noise against float is 3.7e-2 here, and the two round apart).
FLAGSHIP_REL = 8.5e-2
INT8_REL = 0.15  # JAX's bar, int8 against float (tests/test_quant.py)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: float(np.asarray(v))})
    return out


@pytest.fixture(scope="module")
def stem_case():
    """JAX's int8 stem (randomised BN) run calibrate, static and dynamic,
    and with ``pool_impl="pallas"`` (its pool kernel in interpret mode)
    calibrate and static; the same weights in the port."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 64, 32, 1), dtype=np.float32)
    out = {"x": x}
    for pool in ("auto", "pallas"):
        jm = jstem.ResNet18Stem(embed_dim=1024, widths=STEM_WIDTHS, dtype=jnp.bfloat16,
                                quant=True, pool_impl=pool)
        if pool == "auto":
            v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
            params = _randomise(jax.tree.map(np.asarray, v["params"]), rng)
            stats = _randomise(jax.tree.map(np.asarray, v["batch_stats"]), rng)
        var = {"params": params, "batch_stats": stats}
        orig = jpf.pl.pallas_call
        jpf.pl.pallas_call = lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
        try:
            ycal, mut = strict_jit(lambda v, x: jm.apply(v, x, train=False,
                                                         mutable=["quant_stats"]))(var, x)
            qs = jax.tree.map(np.asarray, mut["quant_stats"])
            fwd = strict_jit(lambda v, x: jm.apply(v, x, train=False))
            want = {"calibrate": ycal, "static": fwd({**var, "quant_stats": qs}, x)}
            if pool == "auto":
                want["dynamic"] = fwd(var, x)
        finally:
            jpf.pl.pallas_call = orig
        out[pool] = (params, stats, qs,
                     {k: np.asarray(v.astype(jnp.float32)) for k, v in want.items()})
    return out


def _port_stem(pool):
    return ResNet18Stem(1024, torch.bfloat16, device="cpu", widths=STEM_WIDTHS,
                        quant=True, pool_impl=pool)


def test_int8_stem_matches_jax_in_each_mode(stem_case):
    """Calibrate (float math on the folded BN, the recorded abs-maxes leaf
    for leaf), static (the s8 pool and carry) and dynamic against JAX;
    then the port's own abs-maxes through the JAX tree and back give its
    static bits."""
    params, stats, qs, want = stem_case["auto"]
    model = _port_stem("auto")
    load_jax_params(model, params, stats)
    sites = set(q8.quant_sites(model))
    assert len(sites) == 1 + 6 * 2 + 3 + 5  # pool, conv1/conv2 x 6, proj x 3, out x 5
    xt = _t(stem_case["x"]).permute(0, 3, 1, 2)
    got = {}
    with torch.inference_mode():
        with q8.calibrating():
            got["calibrate"] = model(xt)
        got_qs = model_quant_stats(model)
        got["static"] = model(xt)
        static_bits = got["static"].clone()
        q8.clear_quant_stats(model)
        got["dynamic"] = model(xt)
    g, w = _flat(got_qs), _flat(qs)
    assert g.keys() == w.keys() and len(g) == len(sites)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=STEM_AMAX_RTOL, err_msg=k)
    for mode, y in got.items():
        y = y.float().permute(0, 2, 3, 1).numpy()
        assert y.shape == (2, 1, 8, 256)
        assert _rel(y, want[mode]) < STEM_REL[mode], (mode, _rel(y, want[mode]))
    assert _rel(want["static"], want["calibrate"]) > 1e-3  # int8 really ran
    load_jax_params(model, params, stats, got_qs)
    with torch.inference_mode():
        assert torch.equal(model(xt), static_bits)


def test_int8_stem_with_the_pallas_pool_matches_jax(stem_case):
    """``pool_impl="pallas"`` under int8 (``stem.py:408-416``): the fused
    BN + ReLU + pool (JAX's kernel in interpret mode, the port's K3f twin),
    then the blocks quantize their bf16 input themselves; no ``pool_amax``
    site; calibrate and static against JAX."""
    params, stats, qs, want = stem_case["pallas"]
    model = _port_stem("pallas")
    load_jax_params(model, params, stats)
    assert "pool_amax" not in q8.quant_sites(model)
    xt = _t(stem_case["x"]).permute(0, 3, 1, 2)
    with torch.inference_mode():
        with q8.calibrating():
            cal = model(xt)
        got_qs = model_quant_stats(model)
        static = model(xt)
    g, w = _flat(got_qs), _flat(qs)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=STEM_AMAX_RTOL, err_msg=k)
    for mode, y in (("calibrate", cal), ("static", static)):
        y = y.float().permute(0, 2, 3, 1).numpy()
        assert _rel(y, want[mode]) < STEM_REL[mode], (mode, _rel(y, want[mode]))


def test_padded_flagship_int8_keeps_the_float_predictions():
    """The flagship (embed 768) at depth 1 on a [2, 64, 64, 1] image (JAX's
    test's; the port's position grid needs a width of at least 64): a
    float training state_dict through ``serving_arrays`` (stage 1 padded to
    256) into the int8 model, calibrated on the image: its frame argmax
    equals the float model's and its logits lie within JAX's 0.15 of them
    (``tests/test_quant.py:235-292``); JAX's int8 model on the same padded
    tree and image, calibrated by ``calibrate_quant_stats``, within
    FLAGSHIP_REL of the port's, with the same frame argmax."""
    cfg = port_config(ModelConfig(nb_cls=8, img_size=(64, 64), depth=1))
    fmodel = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    qcfg = dataclasses.replace(cfg, quant="int8")
    qmodel = build_model(qcfg, device="cpu")
    qmodel.load_state_dict(q8.serving_arrays(qcfg, fmodel.state_dict()), strict=True)
    img = np.random.default_rng(3).random((2, 64, 64, 1), dtype=np.float32)
    q8.calibrate_quant_stats(qmodel, [img], 1)
    with torch.inference_mode():
        yf, yq = fmodel(_t(img)).numpy(), qmodel(_t(img)).numpy()
    np.testing.assert_array_equal(yq.argmax(-1), yf.argmax(-1))
    assert _rel(yq, yf) < INT8_REL
    jcfg = ModelConfig(nb_cls=8, img_size=(64, 64), depth=1, quant="int8")
    params, stats = model_to_jax_tree(fmodel)
    pp, ps = jq.serving_arrays(jcfg, params, stats)
    jm = JaxHTRVT(jcfg)
    jqs = jq.calibrate_quant_stats(jm, {"params": pp, "batch_stats": ps}, [img], 1)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": pp, "batch_stats": ps, "quant_stats": jqs}, jnp.asarray(img)))
    assert _rel(yq, want) < FLAGSHIP_REL, _rel(yq, want)
    np.testing.assert_array_equal(yq.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("quant_cli")
    loop.fit(tiny_experiment(out, "q", total=1), device="cpu")
    return os.path.join(str(out), "q")


TINY_FLAGS = ["--embed-dim", "64", "--depth", "1", "--num-heads", "2", "--img-size",
              "128", "64", "--compute-dtype", "float32", "--val-bs", "8",
              "--synth-eval-size", "16", "--device", "cpu"]


def test_test_cli_evaluates_int8_after_calibrating(run_dir, tmp_path, monkeypatch):
    """``cli/test.py --quant int8 --calib-batches 2`` evaluates the EMA model
    at int8, its linears calibrated on the first two eval batches."""
    seen = {}
    orig = cli_test.validate

    def validate(model, *a, **kw):
        seen["stats"] = q8.quant_stats(model)
        return orig(model, *a, **kw)

    monkeypatch.setattr(cli_test, "validate", validate)
    out = str(tmp_path / "preds.json")
    ckpt = _checkpoints(run_dir)[1]
    cli_test.main(["SYNTH", *TINY_FLAGS, "--quant", "int8", "--calib-batches", "2",
                   "--checkpoint", ckpt, "--split", "val", "--predictions-out", out])
    assert os.path.exists(out)
    assert len(seen["stats"]) == 4  # qkv, proj, fc1, fc2


def test_infer_cli_serves_int8_calibrated_on_its_image(run_dir, tmp_path, capsys):
    from PIL import Image
    path = str(tmp_path / "line.png")
    Image.fromarray((np.random.default_rng(0).random((40, 200)) * 255).astype(np.uint8)
                    ).save(path)
    ckpt = _checkpoints(run_dir)[1]
    infer.main(["SYNTH", *TINY_FLAGS, "--quant", "int8", "--checkpoint", ckpt,
                "--image", path])
    assert capsys.readouterr().out.splitlines()[-1].startswith("[raw] ")
