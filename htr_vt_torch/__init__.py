"""htr_vt_torch — the PyTorch / CUDA port of ``htr_vt_tpu`` for NVIDIA Hopper.

The JAX package stays the reference: every module here is held against its
JAX counterpart on the same weights and inputs (``tests/test_torch_port_*``).
Configuration, the text codec, the metrics, the list readers, the image
loader, the synthetic renderer, the augmentation, the batch loader, the
meters, the logging and the checkpoint layout are the port's own copies of
the JAX package's JAX-free modules (``config.py``, ``text/``, ``data/``,
``utils/``); this package imports ``torch``, never ``jax`` and nothing of
``htr_vt_tpu``, and imports cv2 and PIL only inside the functions that
render, read or augment an image.

Ported so far:

- serving: ``cli/serve.py`` -> ``train/step.py:eval_step`` ->
  ``models/htr_vt.py:HTRVT`` + ``ops/ctc.py:ctc_loss_auto``;
- training: ``train/step.py:train_step`` (span masking, train-mode BN, SAM
  + AdamW on the warmup-cosine schedule, EMA) and ``eval/validate.py``;
- the fused stem, ``ModelConfig(bn_stats_impl="pallas", pool_impl="pallas")``:
  the folded train dataflow with its BN statistics (``csrc/bn_stats.cu``)
  and its entry BN + ReLU + max-pool, forward and backward
  (``csrc/pool_fused.cu``), as kernels; with ``conv_impl="pallas"`` too,
  its stride-1 3x3 convs with the BN prologue (``csrc/conv_fused.cu``);
- the wide-width path: width-bucket serving (``cli/serve.py``) and the
  multi-width train step at 1024 and 2048 px, where ``attn_impl="auto"``
  takes flash attention, forward and backward (``csrc/flash_attn.cu``);
- the training program: ``train/loop.py:fit`` over the loader
  (``data/loader.py``), checkpoints on ``torch.save``
  (``train/checkpoint.py``), and the ``cli/train.py``, ``cli/test.py``,
  ``cli/infer.py`` and ``cli/params.py`` entry points (``cli/args.py``);
  ``cli/serve.py`` serves a training checkpoint's EMA weights;
- the variant zoo: every block recipe of ``models/variants.py`` behind the
  ResNet18 or a VAN stem (``models/van.py``), the SGM head and the
  tri-masked trainer, the standalone Swin and SVTR (``models/swin.py``,
  ``models/svtr.py``), and the encoder-decoder with KV-cached generation
  (``models/encoder_decoder.py``), all dispatched by
  ``models/htr_vt.py:build_model`` as the JAX package dispatches them;
- int8 serving (``ops/quant.py``, Q1 ``csrc/conv_int8.cu``);
- deploy and serve: ``deploy.py`` exports the serving program with
  ``torch.export``, holding the serving path's kernels as the custom ops of
  ``ops/library.py``; ``cli/export.py``, the HTTP ``cli/server.py``, beam
  search with n-gram rescoring (``decode/``, ``native/``) in ``cli/serve.py``
  and ``cli/test_with_lm.py``, and the masked-LM corrector in
  ``cli/infer.py``;
- the memory levers and data parallelism: ``cfg.remat`` (``models/remat.py``)
  and ``cfg.train.grad_accum`` (``train/step.py``), and training over
  several processes (``parallel/mesh.py``: the BatchNorm sums, each SAM
  pass's gradient, eval's predictions all-reduced or gathered by hand);
  tensor parallelism of every model's attention and MLP layers over a
  mesh's model axis (``mesh_shape=(R, M)``, ``parallel/mesh.py:shard_model``);
- the multi-width recipe (``cli/train_multiwidth.py``), data preparation
  (``cli/prepare_data.py``, ``data/format_datasets.py``) and
  ``cli/serve.py --selftest``.

On a CUDA tensor the CTC loss runs its alpha recursion, and its gradient
the beta recursion, as hand-written ``sm_90a`` kernels
(``csrc/ctc_alpha.cu``, ``csrc/ctc_beta.cu``).
"""

__version__ = "0.1.0"

from htr_vt_torch.config import (ExperimentConfig, MaskConfig,  # noqa: F401
                                 ModelConfig, OptimConfig, TrainConfig)
from htr_vt_torch.text.converter import CTCLabelConverter  # noqa: F401
