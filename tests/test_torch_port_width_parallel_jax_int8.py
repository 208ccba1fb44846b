"""int8 serving with the image's width sharded over the model axis, two
``gloo`` ranks at (1, 2) on the CPU, against JAX's int8 forward on the
image placed ``P(None, None, "model", None)`` on two of the conftest's
virtual CPU devices: the flagship (embed 768, stage 1 padded to 256) at
depth 1 in bf16 on 64x128 px lines, the same float weights on both stacks
(a seeded port model crossed into JAX's tree by ``utils/convert.py``, then
each stack's ``serving_arrays``), calibrated on one batch (the ranks on
their strips, JAX by its ``calibrate_quant_stats`` on the whole image:
both the whole image's abs-max), then the static forward. Held at the bar
of the port's one-process int8 flagship against JAX's
(``tests/test_torch_port_quant_stem.py:FLAGSHIP_REL``: XLA's ``rsqrt``
rounds a third of the BN variances an ulp off torch's, and int8 codes
follow; measured 2.3e-2 relative L2, as the port's one process on the
whole image reads against JAX on these lines), both ranks equal, and the
argmax equal on every frame whose top-2 margin clears twice the largest
logit gap (the random weights leave many frames near a tie: one of 64
flips here, in the port's one process too).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from htr_vt_tpu.config import ModelConfig as JaxModelConfig
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.ops import quant as jq
from htr_vt_torch.config import ExperimentConfig, config_to_dict
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import quant as q8
from htr_vt_torch.utils.convert import model_to_jax_tree
from test_torch_port_distributed import collect
from test_torch_port_quant_stem import FLAGSHIP_REL, _rel
from test_torch_port_width_parallel import SEED, start_width, tiny_batch
from test_torch_port_width_parallel_int8 import B, WIDTH, int8_cfg


def test_int8_on_strips_matches_jax_on_the_width_sharded_image(tmp_path):
    cfg = int8_cfg("padded")
    fmodel = build_model(dataclasses.replace(cfg, quant="none"), device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
    calib = tiny_batch(92, B, WIDTH)["image"]
    batch = tiny_batch(93, B, WIDTH)
    task = dict(kind="int8", cfg=config_to_dict(ExperimentConfig(model=cfg)),
                weights=q8.serving_arrays(cfg, fmodel.state_dict()), calib=calib,
                batch=batch)
    procs = start_width(tmp_path, (1, 2), {"q": task})
    jcfg = JaxModelConfig(nb_cls=8, img_size=(64, WIDTH), depth=1, quant="int8")
    params, stats = jq.serving_arrays(jcfg, *model_to_jax_tree(fmodel))
    jm = JaxHTRVT(jcfg)
    qs = jq.calibrate_quant_stats(jm, {"params": params, "batch_stats": stats}, [calib], 1)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    image = jax.device_put(jnp.asarray(batch["image"]),
                           NamedSharding(mesh, PartitionSpec(None, None, "model", None)))
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats, "quant_stats": qs}, image))
    ranks = collect(procs, tmp_path)
    got = ranks[0]["q"]["static"]["logits"].numpy()
    assert torch.equal(ranks[1]["q"]["static"]["logits"], ranks[0]["q"]["static"]["logits"])
    assert _rel(got, want) < FLAGSHIP_REL, _rel(got, want)
    top2 = np.sort(want, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * np.abs(got - want).max()
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
