"""int8 serving with the image's width sharded over the model axis, at (1, 2)
on the CPU (two ``gloo`` ranks,
``tests/test_torch_port_width_parallel.py:rank_main``), against the port's
one process on the whole images: the flagship (embed 768) at depth 1 in
bf16 on 64x128 px lines, from a seeded float model's weights through
``ops/quant.py:serving_arrays``, calibrated on one batch, then a static and
a dynamic ``eval_step``. Three forms: stage 1 padded to 256 (every stem
conv int8, the s8 entry pool and the s8 carry crossing the halo exchange),
``pool_impl="pallas"`` (K3f's plain twin on the strip, the blocks
quantizing their bf16 input) and ``quant_stage1_pad=0`` (stage 1 and stage
2's strided conv1 float, through ``models/stem.py:_conv_w2``).

Each abs-max a strip takes is the max over the model group
(``ops/quant.py:record_amax``, ``dynamic_amax``), so the ranks calibrate
one process's scales and quantize with them; the int8 products and their
int32 sums are exact, and the float sites and the epilogues run per column
on the same inputs. So without the input LayerNorm the ranks give one
process's abs-maxes and logits bit for bit in every form, static and
dynamic, and the test holds them so. With it (the flagship's default) the
LayerNorm's statistics come from sums split by rank (``models/layers.py:
global_layer_norm``), an ulp off one process's, and an image value that
lands on a bf16 rounding edge moves by an ulp; through the int8 codes it
flips that moves the logits. Measured on these lines, the padded form:
the abs-maxes equal, the logits 9.7e-3 (static) and 1.3e-2 (dynamic)
relative L2 from one process's, every frame's argmax equal (int8 itself
lies about 5e-2 from float). LN_REL holds that at about twice, below the
int8-against-float gap of the port's JAX tests (``tests/
test_torch_port_quant_stem.py:FLAGSHIP_REL``); the argmax is held on every
frame whose top-2 margin exceeds twice the largest logit gap.
"""

import numpy as np
import pytest
import torch

from htr_vt_torch.config import ExperimentConfig, ModelConfig, config_to_dict
from htr_vt_torch.models.htr_vt import build_model
from test_torch_port_distributed import collect
from test_torch_port_width_parallel import (SEED, int8_run, int8_weights, start_width,
                                            tiny_batch)

B, WIDTH = 2, 128
FORMS = {"padded": {}, "pallas_pool": dict(pool_impl="pallas"),
         "unpadded": dict(quant_stage1_pad=0)}
LN_REL = 3e-2
STATS_RTOL = 1e-3


def int8_cfg(form: str, layer_norm: bool = True) -> ModelConfig:
    return ModelConfig(nb_cls=8, img_size=(64, WIDTH), depth=1, compute_dtype="bfloat16",
                       quant="int8", input_layer_norm=layer_norm, **FORMS[form])


# (form, input LayerNorm) pairs: every form without it, the padded form with it
CASES = [(form, False) for form in FORMS] + [("padded", True)]


@pytest.fixture(scope="module")
def int8_ranks(tmp_path_factory):
    """The ranks' ``int8_task`` of every case and one process's ``int8_run``
    on the whole images, computed while the ranks run."""
    calib = tiny_batch(90, B, WIDTH)["image"]
    batch = tiny_batch(91, B, WIDTH)
    cfgs = {case: int8_cfg(*case) for case in CASES}
    tasks = {f"{form}_{ln}": dict(kind="int8", cfg=config_to_dict(ExperimentConfig(model=cfg)),
                                  weights=int8_weights(SEED, cfg), calib=calib, batch=batch)
             for (form, ln), cfg in cfgs.items()}
    tmp = tmp_path_factory.mktemp("width_int8")
    procs = start_width(tmp, (1, 2), tasks)
    want = {}
    for (form, ln), cfg in cfgs.items():
        model = build_model(cfg, device="cpu")
        model.load_state_dict(tasks[f"{form}_{ln}"]["weights"])
        want[f"{form}_{ln}"] = int8_run(model, calib, batch)
    return collect(procs, tmp), want


@pytest.mark.parametrize("form", list(FORMS))
def test_int8_serving_on_strips_is_one_process_bit_for_bit(int8_ranks, form):
    """Without the input LayerNorm: both ranks calibrate one process's
    abs-maxes and give its static and dynamic logits and losses, bit for
    bit; int8 really ran (static and dynamic logits differ)."""
    ranks, want = int8_ranks
    ref = want[f"{form}_False"]
    assert ref["stats"] and ranks[0][f"{form}_False"]["stats"].keys() == ref["stats"].keys()
    for r in ranks:
        got = r[f"{form}_False"]
        for k, v in ref["stats"].items():
            assert torch.equal(got["stats"][k], v), (form, k)
        for mode in ("static", "dynamic"):
            assert torch.equal(got[mode]["logits"], ref[mode]["logits"]), (form, mode)
            assert got[mode]["loss"] == ref[mode]["loss"]
    assert not torch.equal(ref["static"]["logits"], ref["dynamic"]["logits"])


def test_int8_serving_on_strips_with_the_input_layer_norm(int8_ranks):
    """The padded flagship as configured: the ranks' abs-maxes within
    STATS_RTOL of one process's, their static and dynamic logits within
    LN_REL relative L2 of one process's, the argmax equal on every frame
    whose top-2 margin clears twice the largest gap; both ranks equal."""
    ranks, want = int8_ranks
    ref = want["padded_True"]
    for r in ranks:
        got = r["padded_True"]
        for k, v in ref["stats"].items():
            np.testing.assert_allclose(float(got["stats"][k]), float(v), rtol=STATS_RTOL,
                                       err_msg=k)
        for mode in ("static", "dynamic"):
            a, b = got[mode]["logits"].double(), ref[mode]["logits"].double()
            assert torch.equal(got[mode]["logits"], ranks[0]["padded_True"][mode]["logits"])
            rel = float((a - b).norm() / b.norm())
            assert rel < LN_REL, (mode, rel)
            top2 = b.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > 2 * float((a - b).abs().max())
            assert torch.equal(a.argmax(-1)[clear], b.argmax(-1)[clear]), mode
