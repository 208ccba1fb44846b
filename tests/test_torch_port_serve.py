"""The port's serving slice vs the JAX reference: eval_step, the greedy
collapse and transcribe, plus the port's independence from JAX."""

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import ExperimentConfig
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.ops.decode import collapse_ids as jax_collapse_ids
from htr_vt_tpu.text.converter import CTCLabelConverter
from htr_vt_tpu.train.step import eval_step as jax_eval_step
from htr_vt_torch.cli.profile_serve import category
from htr_vt_torch.cli.serve import charset, transcribe
from htr_vt_torch.ops.decode import collapse_ids
from htr_vt_torch.train.step import eval_step
from test_torch_port_model import (LOGITS_TOL, TINY, port_config,
                                   tiny_jax_weights, tiny_port_model)

REPO = Path(__file__).resolve().parent.parent
# 7 letters + blank = TINY.nb_cls classes
CONVERTER = CTCLabelConverter(list("abcdefg"))


@pytest.fixture(scope="module")
def weights():
    params, stats = tiny_jax_weights(seed=1)
    return params, stats, tiny_port_model(params, stats)


def _jax_eval(params, stats, batch):
    fn = jax.jit(lambda p, s, b: jax_eval_step(JaxHTRVT(TINY), ExperimentConfig(),
                                               p, s, b))
    out = fn(params, stats, {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def test_eval_step_matches_jax(weights):
    params, stats, model = weights
    rng = np.random.default_rng(0)
    b = 4
    lengths = np.array([0, 3, 10, 40], np.int32)  # 40 > 32 frames: infeasible
    labels = rng.integers(1, TINY.nb_cls, (b, 40)).astype(np.int32)
    labels[np.arange(40)[None] >= lengths[:, None]] = 0
    batch = {"image": rng.random((b, 64, 128, 1), dtype=np.float32),
             "labels": labels, "label_lengths": lengths}
    want = _jax_eval(params, stats, batch)
    got = {k: v.numpy() for k, v in eval_step(model, batch).items()}
    np.testing.assert_allclose(got["logits"], want["logits"], **LOGITS_TOL)
    # The loss sums log-probs over 32 frames of logits within LOGITS_TOL.
    np.testing.assert_allclose(got["loss_per_sample"], want["loss_per_sample"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4, atol=1e-4)
    assert got["loss_per_sample"][3] == 0.0 and got["loss_per_sample"][0] > 0
    np.testing.assert_array_equal(got["pred_ids"], want["pred_ids"])
    assert got["pred_ids"].dtype == np.int32


def test_collapse_ids_matches_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 4, (6, 40)).astype(np.int32)  # many blanks, repeats
    ids[0] = 0
    ids[1] = 3
    want = [np.asarray(a) for a in jax_collapse_ids(jnp.asarray(ids))]
    got = [a.numpy() for a in collapse_ids(torch.from_numpy(ids))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[1][0] == 0 and got[1][1] == 1


def test_transcribe_matches_jax_decode(weights):
    params, stats, model = weights
    images = np.random.default_rng(2).random((6, 64, 128, 1), dtype=np.float32)
    images[:, :, 64:] = 1.0  # white right half, as a padded short line
    texts = transcribe(model, images, CONVERTER, batch_size=4)
    # JAX, batch by batch with the same white padding and dummy labels
    padded = np.concatenate([images, np.ones((2, 64, 128, 1), np.float32)])
    want = []
    for s in (0, 4):
        out = _jax_eval(params, stats, {
            "image": padded[s:s + 4], "labels": np.zeros((4, 8), np.int32),
            "label_lengths": np.zeros((4,), np.int32)})
        want += CONVERTER.decode_batch(out["pred_ids"])
    assert texts == want[:6]
    assert any(texts)  # a random model still emits some characters


def test_charset_follows_the_jax_serve_cli(tmp_path):
    assert charset("SYNTH") == sorted(set("abcdefghijklmnopqrstuvwxyz '"))
    root = tmp_path / "lines"
    root.mkdir()
    for name, text in (("a.png", "hello  world"), ("b.png", "Zebra\n")):
        (root / name).write_bytes(b"")
        (root / name).with_suffix(".txt").write_text(text)
    (tmp_path / "train.ln").write_text("a.png\nb.png\n")
    assert charset("IAM", str(tmp_path / "train.ln"), str(root) + "/") == \
        sorted(set("hello worldZebra"))


def test_serve_main_writes_one_record_per_image(tmp_path, monkeypatch):
    """``main`` loads one batch of images at a time and writes what
    ``transcribe`` gives for them, in order (a tiny model in place of the
    preset's flagship)."""
    from PIL import Image

    import htr_vt_torch.cli.serve as serve
    from htr_vt_torch.data.image import load_line_image
    from htr_vt_torch.models.htr_vt import build_model

    small = port_config(dataclasses.replace(TINY, depth=1))
    real_preset = serve.dataset_preset
    monkeypatch.setattr(serve, "dataset_preset", lambda name: dataclasses.replace(
        real_preset(name), model=small))
    converter = CTCLabelConverter(charset("SYNTH"))
    model = build_model(dataclasses.replace(small, nb_cls=converter.num_classes),
                        device="cpu",
                        generator=torch.Generator().manual_seed(4)).eval()
    torch.save(model.state_dict(), tmp_path / "ckpt.pth")
    rng = np.random.default_rng(5)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"line{i}.png"))
        Image.fromarray(rng.integers(0, 256, (40, 150), np.uint8)).save(paths[-1])
    out = tmp_path / "preds.jsonl"
    serve.main(["SYNTH", "--checkpoint", str(tmp_path / "ckpt.pth"), "--images",
                str(tmp_path / "line*.png"), "--batch-size", "2", "--out",
                str(out), "--device", "cpu"])
    records = [json.loads(line) for line in out.read_text().splitlines()]
    images = np.stack([load_line_image(p, 128, 64) for p in paths])
    assert records == [{"image": p, "text": t} for p, t in zip(
        paths, transcribe(model, images, converter, batch_size=2))]


def test_serve_main_routes_lines_to_width_buckets(tmp_path, monkeypatch, capsys):
    """With ``--width-buckets``, ``main`` routes each line by its natural
    width (rounding the buckets up to the stem's stride, with the JAX CLI's
    note) and writes ``transcribe_buckets``'s texts in input order."""
    from PIL import Image

    import htr_vt_torch.cli.serve as serve
    from htr_vt_torch.data.image import load_line_image, natural_line_width
    from htr_vt_torch.models.htr_vt import build_model

    small = port_config(dataclasses.replace(TINY, depth=1))
    real_preset = serve.dataset_preset
    monkeypatch.setattr(serve, "dataset_preset", lambda name: dataclasses.replace(
        real_preset(name), model=small))
    converter = CTCLabelConverter(charset("SYNTH"))
    model = build_model(dataclasses.replace(small, nb_cls=converter.num_classes),
                        device="cpu",
                        generator=torch.Generator().manual_seed(6)).eval()
    torch.save(model.state_dict(), tmp_path / "ckpt.pth")
    rng = np.random.default_rng(7)
    paths = []
    for i, width in enumerate((100, 300, 150, 600)):  # at height 64: 2x wider
        paths.append(str(tmp_path / f"line{i}.png"))
        Image.fromarray(rng.integers(0, 256, (32, width), np.uint8)).save(paths[-1])
    out = tmp_path / "preds.jsonl"
    serve.main(["SYNTH", "--checkpoint", str(tmp_path / "ckpt.pth"), "--images",
                str(tmp_path / "line*.png"), "--batch-size", "2", "--out", str(out),
                "--device", "cpu", "--width-buckets", "254,512"])
    assert "width bucket 254 rounded up to 256" in capsys.readouterr().out
    widths = [natural_line_width(p, 64) for p in paths]
    assert widths == [200, 600, 300, 1200]
    want = serve.transcribe_buckets(
        model, lambda i, w: load_line_image(paths[i], w, 64), widths, [256, 512],
        converter, 2)
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert records == [{"image": p, "text": t} for p, t in zip(paths, want)]


@pytest.mark.parametrize("kernel,label", [
    ("void (anonymous namespace)::flash_dkv_mma(__nv_bfloat16 const*, __nv_bfloat16 "
     "const*, __nv_bfloat16 const*, float const*)",
     "flash attention kernels (K5f, K5dkv, K5dq)"),
    ("void (anonymous namespace)::flash_fwd_wgmma<128>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16*, float*, float*)",
     "flash attention kernels (K5f, K5dkv, K5dq)"),
    ("void (anonymous namespace)::conv_fwd_wgmma<true>(CUtensorMap_st, CUtensorMap_st, "
     "float const*, float const*, __nv_bfloat16*, int, int, int, int)",
     "conv3x3 kernels (K4f, K4d, K4w)"),
    ("void (anonymous namespace)::flash_dkv_wgmma<128>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*)",
     "flash attention kernels (K5f, K5dkv, K5dq)"),
    ("void (anonymous namespace)::wgrad_wgmma<true>(CUtensorMap_st, CUtensorMap_st, "
     "float const*, float const*, float*, int, int, int, int)",
     "conv3x3 kernels (K4f, K4d, K4w)"),
    ("void (anonymous namespace)::flash_dq_wgmma<128>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*)",
     "flash attention kernels (K5f, K5dkv, K5dq)"),
    ("void (anonymous namespace)::conv_dgrad_wgmma<true>(CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16*, int, int, int, int)",
     "conv3x3 kernels (K4f, K4d, K4w)"),
    ("void (anonymous namespace)::pool_bwd_kernel<__nv_bfloat16, true>(CUtensorMap_st, "
     "CUtensorMap_st, float const*, float const*, __nv_bfloat16*, float*, int, int, int)",
     "pool_bn_relu kernels (K3f, K3b)"),
    ("ctc_alpha_kernel(float const*, int const*, bool const*)", "ctc_alpha kernel"),
    ("void (anonymous namespace)::ctc_beta_strided(float const*, int const*, bool "
     "const*, bool const*, bool const*, float*, int, int, int)", "ctc_beta kernel"),
    ("void (anonymous namespace)::bn_stats_kernel<__nv_bfloat16, true>(__nv_bfloat16 "
     "const*, float*, unsigned int*, float*, float*, long long, int, int)",
     "bn_stats kernel (K2)"),
    ("void stem::(anonymous namespace)::sum_partials(float const*, int, int, float*, "
     "float*)", "stem kernels' partial sums"),
    ("void (anonymous namespace)::flash_fwd_f32<__nv_bfloat16, 0>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*)", "flash attention kernels (K5f, K5dkv, K5dq)"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "convolutions (cuDNN)"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "GEMMs (cuBLAS)"),
    ("nvjet_tst_192x128_64x4_2x1_v_bz_coopB_TNT", "GEMMs (cuBLAS)"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<c10::BFloat16>",
     "max pooling"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::direct_copy_"
     "kernel_cuda(at::TensorIteratorBase&)", "dtype casts and copies"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>",
     "norms, softmax, reductions"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_"
     "add<float>>", "elementwise"),
    ("Memset (Device)", "other")])
def test_profile_sorts_kernels_by_category(kernel, label):
    assert category(kernel) == label


@pytest.mark.parametrize("variant", ["clocks", "loads_only"])
def test_pool_breakdown_patches_the_kernel_it_measures(variant):
    """``cli/pool_breakdown.py`` builds its K3b variants by patching fixed
    lines of ``csrc/pool_fused.cu``: every line it needs is there once."""
    from htr_vt_torch.cli import pool_breakdown
    text = pool_breakdown.patched(variant)
    if variant == "clocks":  # the start, six phase ends and the summing store
        assert text.count("clock64()") == 7 and "atomicAdd(&g_pool_clocks" in text
    else:  # the normalise, argmax and gather passes cut
        assert "line < 0;" in text and "if (false) {" in text and "kw < 0;" in text


def test_port_imports_no_jax_and_serves_on_cpu():
    """A clean interpreter imports the port, serves a tiny CPU batch, and
    never loads jax, flax, optax, orbax, cv2 or any module of htr_vt_tpu;
    the CPU path counts no kernel launch."""
    code = textwrap.dedent("""
        import json, sys
        import numpy as np, torch
        import htr_vt_torch
        from htr_vt_torch import CTCLabelConverter
        from htr_vt_torch.cli.serve import transcribe
        import htr_vt_torch.cli.profile_serve
        from htr_vt_torch.models.htr_vt import build_model
        from htr_vt_torch.ops import ctc_cuda
        from htr_vt_torch.ops.ctc import ctc_loss_auto
        cfg = htr_vt_torch.ModelConfig(nb_cls=8, img_size=(64, 128),
                                       embed_dim=64, depth=1, num_heads=2,
                                       compute_dtype="float32")
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        imgs = np.random.default_rng(0).random((3, 64, 128, 1), np.float32)
        texts = transcribe(model, imgs, CTCLabelConverter("abcdefg"), 2)
        loss = ctc_loss_auto(torch.zeros(2, 5, 8), torch.ones(2, 3),
                             torch.tensor([3, 0]))
        print(json.dumps({
            "texts": len(texts), "loss_finite": bool(torch.isfinite(loss).all()),
            "launches": ctc_cuda.ctc_alpha.launches,
            "banned": sorted(m for m in ("jax", "flax", "optax", "orbax", "cv2")
                             if m in sys.modules),
            "htr_vt_tpu": sorted(m for m in sys.modules
                                 if m.split(".")[0] == "htr_vt_tpu")}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"texts": 3, "loss_finite": True, "launches": 0,
                   "banned": [], "htr_vt_tpu": []}
