"""Validation loop (port of ``htr_vt_tpu/eval/validate.py``), single
process: batch CTC loss, greedy decode and CER/WER with the reference's
aggregation (``htr_vt_torch/text/metrics.py``). The train loop passes the EMA
model, as the reference evaluates its EMA weights."""

from __future__ import annotations

from typing import Iterable, List, Mapping, Sequence, Tuple

from torch import nn

from htr_vt_torch.text.converter import CTCLabelConverter
from htr_vt_torch.text.metrics import RecognitionMetrics
from htr_vt_torch.train.step import eval_step


def validate(model: nn.Module,
             batches: Iterable[Tuple[Mapping, int, Sequence[str]]],
             converter: CTCLabelConverter
             ) -> Tuple[float, float, float, List[str], List[str]]:
    """batches: (batch, num_valid, texts) triples, where only the first
    ``num_valid`` rows of a batch are real (the rest pad the last batch).
    Returns (val_loss, CER, WER, predictions, labels); the loss is the mean
    over valid rows only (``validate.py:64-73``)."""
    metrics = RecognitionMetrics()
    total_loss, count = 0.0, 0
    all_preds: List[str] = []
    all_labels: List[str] = []
    for batch, valid, texts in batches:
        out = eval_step(model, batch)
        preds = converter.decode_batch(out["pred_ids"][:valid].cpu().numpy())
        metrics.update(preds, texts)
        total_loss += float(out["loss_per_sample"][:valid].sum())
        count += valid
        all_preds.extend(preds)
        all_labels.extend(texts)
    return (total_loss / max(1, count), metrics.cer, metrics.wer,
            all_preds, all_labels)
