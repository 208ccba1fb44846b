"""The multi-width recipe of the port (``htr_vt_torch/cli/train_multiwidth.py``)
against the JAX tool (``tools/train_multiwidth.py``) on the CPU:

- the buckets: for the tool's seeds, each bucket's rendered images, labels,
  the shared alphabet, ``max_label_len`` and the first loader batch
  (augmentation on) equal what the tool builds from the JAX package;
- the steps: four steps taking widths 128 and 256 in turn, through
  ``run`` from weights converted by ``utils/convert.py`` (masking off, a
  first LR of 1e-6, float32), against JAX's ``jit_train_step`` of the tool's
  per-width models on the same batches, losses and gradient norms within
  ``STEP_RTOL`` at each width's first step and ``DRIFT_RTOL`` after;
- the CLI: ``main`` at the JAX smoke test's tiny sizes
  (``tests/test_multiwidth_tool.py``) writes ``best_CER`` and a summary
  with the tool's keys.
"""

import ast
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from htr_vt_tpu.config import (ExperimentConfig, MaskConfig, ModelConfig, OptimConfig,
                               TrainConfig)
from htr_vt_tpu.data.loader import TrainLoader as JaxTrainLoader
from htr_vt_tpu.data.loader import choose_max_label_len as jax_choose_max_label_len
from htr_vt_tpu.data.synthetic import SyntheticLineDataset as JaxSyntheticLineDataset
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.text.converter import CTCLabelConverter as JaxConverter
from htr_vt_tpu.train.step import jit_train_step
from htr_vt_torch.cli import train_multiwidth as mw
from test_torch_port_memory_levers import jax_init, port_state
from test_torch_port_model import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--iters", "4", "--bs", "4", "--widths", "128,256", "--train-size", "8",
        "--eval-size", "4", "--eval-every", "4", "--embed-dim", "64", "--depth", "1",
        "--num-heads", "2"]
# Four SAM steps of the port against JAX from the same weights at an LR of
# 1e-6 (the weights barely move), float32 sums in other orders. Each width's
# first step (steps 1 and 2): the losses within 1e-5, the gradient norm
# within the port's one-step SAM bar (tests/test_torch_port_memory_levers.py:
# STEP_RTOL, 1e-4; read 1.5e-5 at 256 px). Steps 3 and 4 at JAX's drift bar
# for two programs (tests/test_parallel.py:41-55, ~1e-3): the tiny stem
# turns the first steps' Adam sign flips (1e-6 an element) into gradient
# norms 2.1e-4 apart at step 3 (read; its losses within 1e-5).
STEP_RTOL = {"loss": 1e-5, "loss_second": 1e-5, "grad_norm": 1e-4}
DRIFT_RTOL = 1e-3


def tiny_args(tmp_path, *extra):
    return mw.build_parser().parse_args(TINY + ["--out", str(tmp_path), "--device", "cpu",
                                                *extra])


def test_the_buckets_are_the_tools(tmp_path):
    """``make_buckets`` and ``prepare`` against the tool's construction
    (``tools/train_multiwidth.py:75-106``) from the JAX package."""
    args = tiny_args(tmp_path)
    buckets = mw.make_buckets(args)
    jax_buckets = []
    for bi, w in enumerate((128, 256)):
        lo, hi = mw.len_range(w)
        jax_buckets.append({"w": w, **{
            split: JaxSyntheticLineDataset(n, seed=args.seed + 10 * bi + k, width=w,
                                           min_len=lo, max_len=hi, trim_to_canvas=True)
            for split, n, k in (("train", args.train_size, 0), ("val", args.eval_size, 1))}})
    converter = mw.shared_converter(buckets)
    jconv = JaxConverter(sorted(set().union(*[set(b["train"].alphabet)
                                              for b in jax_buckets])))
    assert converter.character == jconv.character
    cfg = mw.base_config(args, converter.num_classes)
    mw.prepare(buckets, cfg, args, converter)
    try:
        for b, jb in zip(buckets, jax_buckets):
            for split in ("train", "val"):
                assert b[split].labels == jb[split].labels
                for i in range(len(b[split])):
                    assert np.array_equal(b[split][i][0], jb[split][i][0])
            assert b["max_label_len"] == jax_choose_max_label_len(
                jb["train"].labels, b["w"] // 4)
            jl = JaxTrainLoader(jb["train"], jconv, args.bs, b["max_label_len"],
                                augment=cfg.data.augment, seed=args.seed + b["w"],
                                num_threads=4)
            try:
                got, want = next(b["loader"]), next(jl)
            finally:
                jl.close()
            assert got.keys() == want.keys()
            for k in want:
                assert np.array_equal(got[k], want[k]), (b["w"], k)
    finally:
        for b in buckets:
            b["loader"].close()


def test_four_alternating_steps_match_jax(tmp_path, monkeypatch):
    args = tiny_args(tmp_path, "--max-lr", "1e-6", "--eval-every", "100")
    buckets = mw.make_buckets(args)
    converter = mw.shared_converter(buckets)
    optim = mw.base_config(args, converter.num_classes).optim
    jcfg = ExperimentConfig(
        model=ModelConfig(nb_cls=converter.num_classes, img_size=(64, 128), embed_dim=64,
                          depth=1, num_heads=2, compute_dtype="float32",
                          masking=MaskConfig(mode="none")),
        optim=OptimConfig(**dataclasses.asdict(optim)),
        train=TrainConfig(out_dir=str(tmp_path), exp_name="", seed=args.seed))
    init = jax_init(jcfg, 3, None)
    state = port_state(jcfg, init)
    seen, got = [], []

    def recorded(st, batch):
        seen.append({k: np.array(v) for k, v in batch.items()})
        m = mw_train_step(st, batch)
        got.append({k: float(v) for k, v in m.items()})
        return m

    mw_train_step = mw.train_step
    monkeypatch.setattr(mw, "train_step", recorded)
    mw.run(buckets, port_config(jcfg), args, "cpu", state=state)
    assert [b["image"].shape[2] for b in seen] == [128, 256, 128, 256]

    steps = {w: jit_train_step(JaxHTRVT(dataclasses.replace(
        jcfg.model, img_size=(64, w))), dataclasses.replace(jcfg, model=dataclasses.replace(
            jcfg.model, img_size=(64, w))), donate=False) for w in (128, 256)}
    jstate = init
    for i, (batch, m) in enumerate(zip(seen, got)):
        jstate, jm = steps[batch["image"].shape[2]](
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        for key, rtol in STEP_RTOL.items():
            np.testing.assert_allclose(m[key], float(jm[key]),
                                       rtol=rtol if i < 2 else DRIFT_RTOL,
                                       err_msg=f"step {i + 1} {key}")


def summary_keys():
    """The keys of the summary dict the JAX tool writes, read from its
    source."""
    with open(os.path.join(REPO, "tools", "train_multiwidth.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "summary":
            return {k.value for k in node.value.keys}
    raise AssertionError("no summary in tools/train_multiwidth.py")


def test_main_writes_best_cer_and_the_tools_summary(tmp_path):
    out = tmp_path / "mw"
    mw.main(TINY + ["--out", str(out), "--device", "cpu"])
    summary = json.load(open(out / "multiwidth_summary.json"))
    assert set(summary) == summary_keys()
    assert summary["widths"] == [128, 256] and summary["final"]["iter"] == 4
    for w in ("128", "256"):
        assert 0.0 <= summary["final"][w]["cer"] < 10.0
        assert summary["final"][w]["eval_ms_per_batch"] > 0
    assert os.path.exists(out / "best_CER")
    with open(out / "best_CER" / "meta.json") as f:
        meta = json.load(f)
    assert meta["widths"] == [128, 256] and meta["history"] == summary["history"]


def test_the_recipe_imports_no_image_library():
    """The module imports neither cv2 nor PIL (the card's machine has
    neither): ``run`` trains on in-memory lines."""
    with open(mw.__file__) as f:
        tree = ast.parse(f.read())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = {a.name.split(".")[0] for n in top for a in n.names} | {
        (n.module or "").split(".")[0] for n in top if isinstance(n, ast.ImportFrom)}
    assert not names & {"cv2", "PIL"}
