"""The SGM head of ``test_torch_port_sgm.py``'s recipe against JAX on the
CPU: the copied vocabulary and context windows, the head's loss and
gradient; then ``cli/train.py --encoder conformer --tri-masked
--sgm-enable`` end to end, and its checkpoint read back by ``cli/test.py``
(the strict-subset restore) and ``serve --checkpoint``. (The tri-masked
SAM steps, whose eager JAX step takes most of that file's time, stay
there.)
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.models import sgm as jsgm
from htr_vt_tpu.text.converter import CTCLabelConverter as JaxConverter
from htr_vt_torch.cli import serve
from htr_vt_torch.cli import test as cli_test
from htr_vt_torch.cli import train as cli_train
from htr_vt_torch.models import sgm
from htr_vt_torch.text.converter import CTCLabelConverter
from htr_vt_torch.train.checkpoint import CheckpointManager, load_ema_model
from htr_vt_torch.utils.convert import load_jax_module
from test_torch_port_model import _randomise, no_tensorboard  # noqa: F401
from test_torch_port_sgm import (ALPHABET, B, HEAD_TOL, LMAX, N, SGM, SUB, _leaves,
                                 _sgm_arrays, _texts)


def test_vocab_and_context_arrays_copy_the_jax_ones():
    rng = np.random.default_rng(0)
    texts = _texts(rng, 9) + [""]
    want_vocab = jsgm.SGMVocab(JaxConverter(list(ALPHABET)))
    got_vocab = sgm.SGMVocab(CTCLabelConverter(list(ALPHABET)))
    assert got_vocab.stoi == want_vocab.stoi and got_vocab.itos == want_vocab.itos
    assert got_vocab.size == want_vocab.size == SGM.vocab_size
    for max_len, sub_len in ((LMAX, SUB), (4, 5), (8, 1)):
        got = sgm.make_context_arrays(texts, got_vocab, max_len, sub_len)
        want = jsgm.make_context_arrays(texts, want_vocab, max_len, sub_len)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)



def test_sgm_head_loss_and_gradient_match_jax():
    """Loss and the gradient of every head parameter and of the visual
    tokens (eval: no dropout), float32."""
    rng = np.random.default_rng(1)
    vis = rng.standard_normal((B, N, 64)).astype(np.float32)
    arrays = _sgm_arrays(_texts(rng, B))
    jhead = jsgm.SGMHead(vocab_size=SGM.vocab_size, char_emb_dim=16, dtype=jnp.float32)
    args = [arrays[k] for k in ("sgm_left", "sgm_right", "sgm_tgt", "sgm_mask")]
    params = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(0), vis, *args)["params"])
    params = _randomise(params, rng)
    (want, (gp, gv)) = jax.value_and_grad(
        lambda p, v: jhead.apply({"params": p}, v, *args), argnums=(0, 1))(params, vis)
    thead = sgm.SGMHead(64, SGM.vocab_size, torch.float32, char_emb_dim=16)
    load_jax_module(thead, params)
    v = torch.from_numpy(vis).requires_grad_(True)
    got = thead(v, *(torch.from_numpy(a) for a in args))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **HEAD_TOL)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(gv), rtol=1e-4, atol=1e-7)
    got_g = {f"sgm_head/{k}": t.grad.numpy() for k, t in thead.named_parameters()}
    want_g = _leaves(gp)
    names = {"char_emb/weight": "char_emb/embedding", "txt_proj/weight": "txt_proj/kernel",
             "classifier/weight": "classifier/kernel", "q_norm/weight": "q_norm/scale",
             "kv_norm/weight": "kv_norm/scale"}
    assert len(got_g) == len(want_g)
    for k, g in got_g.items():
        key = k.split("/", 1)[1].replace(".", "/")
        w = want_g[names.get(key, key)]
        g = g.T if g.ndim == 2 and key.endswith("weight") and "emb" not in key else g
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7, err_msg=key)


# --- the CLI, end to end --------------------------------------------------------
TINY_FLAGS = ["--encoder", "conformer", "--embed-dim", "64", "--depth", "1",
              "--num-heads", "2", "--img-size", "128", "64", "--compute-dtype", "float32"]


@pytest.fixture(scope="module")
def sgm_run_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sgm_cli"))
    cli_train.main(["SYNTH", *TINY_FLAGS, "--tri-masked", "--sgm-enable", "--exp-name", "sgm",
                    "--out-dir", out, "--train-bs", "8", "--val-bs", "8",
                    "--total-iter", "2", "--eval-iter", "2", "--print-iter", "1",
                    "--warm-up-iter", "1", "--synth-train-size", "16",
                    "--synth-eval-size", "8", "--num-workers", "2", "--device", "cpu"])
    return os.path.join(out, "sgm")


def test_sgm_checkpoint_is_read_by_test_and_serve(sgm_run_dir, tmp_path):
    """The run's checkpoint holds the SGM head. ``cli/test.py`` builds the
    model from its flags (no SGM vocabulary, so no head) and restores the
    strict subset; ``serve --checkpoint`` builds it at the saved config,
    head included, and serves the EMA weights."""
    payload, meta = CheckpointManager(sgm_run_dir).read(os.path.join(sgm_run_dir, "best_CER"))
    assert any(k.startswith("sgm_head.") for k in payload["ema_model"])
    assert meta["config"]["model"]["sgm"]["vocab_size"] > 0
    out = str(tmp_path / "preds.json")
    cli_test.main(["SYNTH", *TINY_FLAGS, "--sgm-enable", "--checkpoint",
                   os.path.join(sgm_run_dir, "best_CER"), "--split", "val", "--val-bs", "8",
                   "--synth-eval-size", "8", "--predictions-out", out, "--device", "cpu"])
    with open(out) as f:
        assert len(json.load(f)["samples"]) == 8
    model = serve.load_serving_model(sgm_run_dir, None, "cpu")
    assert model.sgm_head is not None
    for k, v in model.state_dict().items():
        assert torch.equal(v, payload["ema_model"][k]), k
    # the same weights without the head, as an eval config builds them
    cfg = dataclasses.replace(model.cfg, sgm=dataclasses.replace(model.cfg.sgm, enable=False))
    bare = load_ema_model(sgm_run_dir, cfg, "cpu")
    assert bare.sgm_head is None
    x = np.random.default_rng(0).random((2, 64, 128, 1), np.float32)
    with torch.inference_mode():
        assert torch.equal(bare(torch.from_numpy(x)), model(torch.from_numpy(x)))
