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

Ported so far, for the flagship ``model_v1`` recipe:

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
  ``cli/serve.py`` serves a training checkpoint's EMA weights.

On a CUDA tensor the CTC loss runs its alpha recursion, and its gradient
the beta recursion, as hand-written ``sm_90a`` kernels
(``csrc/ctc_alpha.cu``, ``csrc/ctc_beta.cu``).
"""

__version__ = "0.1.0"

from htr_vt_torch.config import (ExperimentConfig, MaskConfig,  # noqa: F401
                                 ModelConfig, OptimConfig)
from htr_vt_torch.text.converter import CTCLabelConverter  # noqa: F401
