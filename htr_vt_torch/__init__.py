"""htr_vt_torch — the PyTorch / CUDA port of ``htr_vt_tpu`` for NVIDIA Hopper.

The JAX package stays the reference: every module here is held against its
JAX counterpart on the same weights and inputs (``tests/test_torch_port_*``).
Configuration, the text codec, the metrics, the list readers and the
checkpoint layout are shared with ``htr_vt_tpu`` through its JAX-free
modules; this package imports ``torch`` and never ``jax``.

Ported so far, for the flagship ``model_v1`` recipe:

- serving: ``cli/serve.py`` -> ``train/step.py:eval_step`` ->
  ``models/htr_vt.py:HTRVT`` + ``ops/ctc.py:ctc_loss_auto``;
- training: ``train/step.py:train_step`` (span masking, train-mode BN, SAM
  + AdamW on the warmup-cosine schedule, EMA) and ``eval/validate.py``.

On a CUDA tensor the CTC loss runs its alpha recursion, and its gradient
the beta recursion, as hand-written ``sm_90a`` kernels
(``csrc/ctc_alpha.cu``, ``csrc/ctc_beta.cu``).
"""

__version__ = "0.1.0"

from htr_vt_tpu.config import (ExperimentConfig, MaskConfig,  # noqa: F401
                               ModelConfig, OptimConfig)
from htr_vt_tpu.text.converter import CTCLabelConverter  # noqa: F401
