"""Validation loop (port of ``htr_vt_tpu/eval/validate.py``): batch CTC
loss, greedy decode and CER/WER with the reference's aggregation
(``htr_vt_torch/text/metrics.py``). The train loop passes the EMA model, as
the reference evaluates its EMA weights, and for an encoder-decoder
``train/step.py:eval_step_ed`` with its tokenizer as the codec.

Under data parallelism (``validate.py:38-60``) every rank iterates the same
global eval batches and runs its data index's slice of each batch's rows;
the predictions and per-row losses are all-gathered over the data axis
(the encoder-decoder's batch loss averaged), so CER, WER and the loss, and
the train loop's best-checkpoint decisions with them, agree on every rank.
The ranks of one data index (a model axis) run the same rows through their
shards of the model."""

from __future__ import annotations

from typing import Callable, Iterable, List, Mapping, Sequence, Tuple

from torch import nn

from htr_vt_torch.parallel.mesh import all_gather_rows, all_reduce_mean_, data_world
from htr_vt_torch.text.metrics import RecognitionMetrics
from htr_vt_torch.train.step import eval_step


def validate(model: nn.Module,
             batches: Iterable[Tuple[Mapping, int, Sequence[str]]],
             converter, eval_fn: Callable = eval_step
             ) -> Tuple[float, float, float, List[str], List[str]]:
    """batches: (batch, num_valid, texts) triples, where only the first
    ``num_valid`` rows of a batch are real (the rest pad the last batch).
    ``converter``: any codec with ``decode_batch`` (the CTC converter, the
    ED tokenizer); ``eval_fn(model, batch)``: ``eval_step`` or
    ``eval_step_ed``. Returns (val_loss, CER, WER, predictions, labels); the
    loss is the mean over valid rows where ``eval_fn`` gives per-row losses
    (``validate.py:64-73``), else the mean of the batch losses."""
    rank, size = data_world()
    metrics = RecognitionMetrics()
    total_loss, count = 0.0, 0
    all_preds: List[str] = []
    all_labels: List[str] = []
    for batch, valid, texts in batches:
        if size > 1:
            rows = batch["image"].shape[0]
            if rows % size:
                raise ValueError(f"eval batch size {rows} not divisible by the "
                                 f"data axis, {size}; pass a divisible --val-bs")
            m = rows // size
            batch = {k: v[rank * m:(rank + 1) * m] for k, v in batch.items()}
        out = eval_fn(model, batch)
        pred_ids = all_gather_rows(out["pred_ids"])
        preds = converter.decode_batch(pred_ids[:valid].cpu().numpy())
        metrics.update(preds, texts)
        if "loss_per_sample" in out:
            total_loss += float(all_gather_rows(out["loss_per_sample"])[:valid].sum())
            count += valid
        else:
            loss = out["loss"].detach().clone()
            all_reduce_mean_([loss])
            total_loss += float(loss)
            count += 1
        all_preds.extend(preds)
        all_labels.extend(texts)
    return (total_loss / max(1, count), metrics.cer, metrics.wer,
            all_preds, all_labels)
