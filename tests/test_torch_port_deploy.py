"""The port's serving bundles (``htr_vt_torch/deploy.py``) on the CPU, against
the JAX package's StableHLO bundles of the same weights
(``htr_vt_tpu/deploy.py``) and, as ``tests/test_deploy.py`` pins JAX's, bit
for bit against the live model: partial batches, multi-width routing, the
format guard; a bundle exported for ``cuda`` refuses the CPU, and a process
that loads a bundle imports no model module. The exported graphs' ``htrvt::``
ops and ``cli/export.py`` are in ``tests/test_torch_port_export.py``."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.deploy import ServingBundle as JaxServingBundle
from htr_vt_tpu.deploy import export_serving as jax_export_serving
from htr_vt_tpu.deploy import save_bundle as jax_save_bundle
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_torch.deploy import (ServingBundle, export_serving, make_serving_fn,
                                 save_bundle)
from test_torch_port_model import (LOGITS_TOL, TINY, tiny_jax_weights,
                                   tiny_port_model)

REPO = Path(__file__).resolve().parent.parent
CHARSET = ["[blank]"] + list("abcdefg")  # TINY.nb_cls classes
META = {"charset": CHARSET, "height": 64, "batch_size": 2, "quant": "float",
        "device": "cpu"}
FUSED = dict(bn_stats_impl="pallas", pool_impl="pallas", conv_impl="pallas")
WIDTHS = (128, 256)
# Rows compared with the JAX bundle: batches of the bundles' size.
JAX_ROWS = 8


def images(seed, n=2, width=128):
    return np.random.default_rng(seed).random((n, 64, width, 1), np.float32)


def live(model, img):
    """The live model's serving function on ``img``: (ids, lengths) numpy."""
    with torch.no_grad():
        ids, lengths = make_serving_fn(model)(torch.from_numpy(img))
    return ids.numpy(), lengths.numpy()


def write_bundle(out, model, widths=(128,), batch_size=2):
    save_bundle(str(out), {w: export_serving(model, batch_size, (64, w))
                           for w in widths}, dict(META, batch_size=batch_size))
    return str(out)


@pytest.fixture(scope="module")
def weights():
    params, stats = tiny_jax_weights(seed=3)
    return params, stats, tiny_port_model(params, stats)


@pytest.fixture(scope="module")
def bundle_dir(weights, tmp_path_factory):
    """The tiny model's bundle at 128 and 256 px, bs 2."""
    return write_bundle(tmp_path_factory.mktemp("bundle"), weights[2], WIDTHS)


def _copy(bundle_dir, tmp_path):
    out = str(tmp_path / "bundle")
    shutil.copytree(bundle_dir, out)
    return out


def test_bundle_agrees_with_the_jax_bundle(weights, bundle_dir):
    """The same weights through JAX's StableHLO bundle and the port's: the
    live logits within the parity bar, and every row whose frames are all
    decidable (float32 top-2 margin at least ten times the bar) decodes to
    the same collapsed ids and length in both bundles."""
    params, stats, model = weights
    jvars = {"params": jax.tree.map(jnp.asarray, params),
             "batch_stats": jax.tree.map(jnp.asarray, stats)}
    jdir = os.path.join(os.path.dirname(bundle_dir), "jax")
    jax_save_bundle(jdir, {128: jax_export_serving(JaxHTRVT(TINY), jvars, 2, (64, 128))},
                    META)
    jbundle, bundle = JaxServingBundle(jdir), ServingBundle(bundle_dir)
    img = images(5, n=JAX_ROWS)
    want_logits = np.asarray(jax.jit(lambda v, x: JaxHTRVT(TINY).apply(
        v, x, train=False))(jvars, img))
    with torch.no_grad():
        got_logits = model(torch.from_numpy(img), train=False).numpy()
    np.testing.assert_allclose(got_logits, want_logits, **LOGITS_TOL)
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    bar = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * np.abs(top2[..., 1])
    decided = ((top2[..., 1] - top2[..., 0]) >= 10 * bar).all(axis=1)
    assert decided.sum() >= JAX_ROWS // 2, decided
    got = [np.concatenate(a) for a in zip(*(bundle.run(img[i:i + 2])
                                            for i in range(0, JAX_ROWS, 2)))]
    want = [np.concatenate(a) for a in zip(*(jbundle.run(img[i:i + 2])
                                             for i in range(0, JAX_ROWS, 2)))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[decided], w[decided])
    assert bundle.decode(*(g[decided] for g in got)) == \
        jbundle.decode(*(w[decided] for w in want))


def test_export_roundtrip_bit_exact(weights, bundle_dir):
    bundle = ServingBundle(bundle_dir)
    img = images(0)
    ids, lengths = bundle.run(img)
    ref_ids, ref_len = live(weights[2], img)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(lengths, ref_len)
    assert ids.dtype == np.int32 and lengths.dtype == np.int32
    for text, n in zip(bundle.decode(ids, lengths), lengths):
        assert len(text) == int(n) and set(text) <= set("abcdefg")


def test_fused_export_roundtrip_bit_exact(weights, tmp_path):
    """The fully fused switches (on the CPU the kernels' plain twins,
    reached through the ``htrvt::`` ops)."""
    params, stats, _ = weights
    model = tiny_port_model(params, stats, dataclasses.replace(TINY, **FUSED))
    bundle = ServingBundle(write_bundle(tmp_path / "bundle", model))
    img = images(4)
    for got, want in zip(bundle.run(img), live(model, img)):
        np.testing.assert_array_equal(got, want)


def test_transcribe_pads_partial_batches(weights, bundle_dir):
    bundle = ServingBundle(bundle_dir)
    img = images(1, n=3)
    texts = bundle.transcribe(img)
    assert len(texts) == 3  # 2 full + 1 padded chunk, padding dropped
    assert texts[:2] == bundle.transcribe(img[:2])
    ids, lengths = live(weights[2], np.concatenate([img[2:], np.ones_like(img[:1])]))
    assert texts[2] == bundle.decode(ids, lengths)[0]


def test_multi_width_bundle_routes_by_width(weights, bundle_dir):
    bundle = ServingBundle(bundle_dir)
    assert bundle.widths == list(WIDTHS)
    for width in WIDTHS:
        img = images(2, width=width)
        ids, _ = bundle.run(img)
        np.testing.assert_array_equal(ids, live(weights[2], img)[0])
    with pytest.raises(KeyError):
        bundle.run(np.zeros((2, 64, 64, 1), np.float32))


def test_format_version_guard(bundle_dir, tmp_path):
    out = _copy(bundle_dir, tmp_path)
    meta_path = os.path.join(out, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["format_version"] == 1 and meta["widths"] == list(WIDTHS)
    assert sorted(os.listdir(out)) == ["meta.json", "w0128.pt2", "w0256.pt2"]
    meta["format_version"] = 999
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="bundle format"):
        ServingBundle(out)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_a_cuda_bundle_refuses_the_cpu(bundle_dir, tmp_path):
    out = _copy(bundle_dir, tmp_path)
    meta_path = os.path.join(out, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    with open(meta_path, "w") as f:
        json.dump(dict(meta, device="cuda"), f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingBundle(out)


def test_loading_a_bundle_imports_no_model_module(bundle_dir):
    """The deployment contract: a process that loads and runs a bundle, and
    imports the HTTP server's worker, imports nothing of the model code (nor
    of JAX)."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from htr_vt_torch.deploy import ServingBundle
        from htr_vt_torch.cli.server import BatchWorker
        bundle = ServingBundle({bundle_dir!r})
        print(bundle.transcribe(np.ones((3, 64, 128, 1), np.float32)))
        bad = sorted(m for m in sys.modules
                     if m.startswith(("htr_vt_torch.models", "htr_vt_tpu", "jax")))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
