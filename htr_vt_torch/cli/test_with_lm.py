"""Evaluation with CTC beam search + n-gram LM rescoring (port of
``htr_vt_tpu/cli/test_with_lm.py``).

    python -m htr_vt_torch.cli.test_with_lm IAM --checkpoint out/iam/best_CER \\
        --arpa lm.arpa [--proper-beam] [--char-lm] [--lm-in-beam] [--device cpu]

Mirrors model_window/test_with_kenlm.py: per sample, a beam search over the
log-probabilities of the port's ``eval_step`` logits (the EMA weights of a
port checkpoint), candidates collapsed to text, rescored with an ARPA LM
(or a compiled ``.htlm``), the best picked; reports CER/WER beside greedy
and writes ``kenlm_correction_results.json``. The JAX flags and their
meaning are kept: ``--proper-beam`` takes the prefix-merging beam search
instead of the reference's frame-wise top-k, ``--char-lm`` reads the LM as
character-level, ``--lm-in-beam`` fuses it into the prefix beam search.
CER is aggregated per character.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from htr_vt_torch.cli.args import args_to_config, build_parser
from htr_vt_torch.data.loader import (build_dataset, choose_max_label_len,
                                      eval_batches, make_converter)
from htr_vt_torch.decode.beam import (collapse_sequence, prefix_beam_search_batch,
                                      simple_beam_search_batch)
from htr_vt_torch.decode.lm import NgramScorer, rescore_candidates
from htr_vt_torch.text.metrics import RecognitionMetrics
from htr_vt_torch.train.checkpoint import load_ema_model
from htr_vt_torch.train.step import eval_step


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = build_parser("htr_vt_torch LM-rescored evaluator")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--arpa", type=str, required=True,
                        help="n-gram LM: ARPA TEXT (train one with "
                             "decode/lm_train.py, or kenlm's lmplz -o N) or "
                             "this framework's compiled .htlm binary "
                             "(python -m htr_vt_torch.decode.lm_compile; "
                             "bit-identical scores, faster load). "
                             "kenlm's own compiled .binary/.klm files are "
                             "NOT supported — re-export ARPA and compile")
    parser.add_argument("--beam-width", type=int, default=5)
    parser.add_argument("--lm-weight", type=float, default=1.0)
    parser.add_argument("--ctc-weight", type=float, default=0.0)
    parser.add_argument("--proper-beam", action="store_true", default=False)
    parser.add_argument("--char-lm", action="store_true", default=False,
                        help="ARPA is character-level (tokens = chars, <sp> for space)")
    parser.add_argument("--lm-in-beam", action="store_true", default=False,
                        help="fuse the (char-level) LM into the prefix beam "
                             "search itself instead of rescoring finished "
                             "candidates; implies --proper-beam --char-lm")
    parser.add_argument("--split", type=str, default="test", choices=["val", "test"])
    parser.add_argument("--results-out", type=str, default=None)
    args = parser.parse_args(argv)
    cfg = args_to_config(args)
    if cfg.model.model_type == "encoder_decoder":
        raise NotImplementedError(
            "--model-type encoder_decoder: this entry point beam-searches the CTC "
            "eval_step's logits, which an encoder-decoder cannot give (neither can "
            "the JAX package's); its beam is models/encoder_decoder.py:generate")

    train_ds = build_dataset(cfg.data, "train")
    eval_ds = build_dataset(cfg.data, args.split)
    converter = make_converter(cfg.data, train_ds)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, nb_cls=converter.num_classes))
    max_label_len = choose_max_label_len(train_ds.labels, cfg.model.num_tokens)
    model = load_ema_model(args.checkpoint, cfg.model, args.device)
    scorer = NgramScorer(args.arpa)
    if args.lm_in_beam:
        args.proper_beam = args.char_lm = True
    if args.char_lm:
        from htr_vt_torch.decode.lm_train import chars_for_lm
        base_score = scorer.score
        scorer.score = lambda text: base_score(chars_for_lm(text))

    indexed_lm, lm_lut = None, None
    if args.lm_in_beam:
        # LM tokens per CTC class: chars, space as <sp> (decode/lm_train.py)
        vocab = ["<sp>" if ch == " " else ch
                 for ch in converter.character[1:]]
        indexed_lm = scorer.indexed(vocab)
        lm_lut = np.concatenate([[-1], np.arange(len(vocab))]).astype(np.int32)

    def ids_to_text(ids) -> str:
        return "".join(converter.character[i] for i in ids
                       if 0 < i < len(converter.character))

    metrics, greedy_metrics = RecognitionMetrics(), RecognitionMetrics()
    records = []
    n_images, decode_secs, t_start = 0, 0.0, time.perf_counter()
    for batch, valid, texts in eval_batches(eval_ds, converter, cfg.data.val_bs,
                                            max_label_len):
        out = eval_step(model, batch)
        logp = torch.log_softmax(out["logits"], -1).cpu().numpy()[:valid]
        greedy = converter.decode_batch(out["pred_ids"].cpu().numpy()[:valid])
        t0 = time.perf_counter()
        if args.proper_beam:
            batch_beams = prefix_beam_search_batch(
                logp, beam_width=args.beam_width,
                lm=indexed_lm, lm_weight=args.lm_weight if args.lm_in_beam else 0.0,
                lm_id_of_class=lm_lut)
        else:
            batch_beams = simple_beam_search_batch(
                logp, beam_width=args.beam_width, top_k_per_frame=args.beam_width)
        decode_secs += time.perf_counter() - t0
        n_images += valid
        for bi, (gt, gr) in enumerate(zip(texts, greedy)):
            if args.proper_beam:
                cands = [(ids_to_text(seq), score)
                         for seq, score in batch_beams[bi]]
            else:
                cands = [(ids_to_text(collapse_sequence(seq)), score)
                         for seq, score in batch_beams[bi]]
            if args.lm_in_beam:
                # the LM already shaped the beam; take its top hypothesis
                best = cands[0][0] if cands else ""
            else:
                best = rescore_candidates(cands, scorer, args.lm_weight,
                                          args.ctc_weight)[0][0] if cands else ""
            metrics.update([best], [gt])
            greedy_metrics.update([gr], [gt])
            records.append({"ground_truth": gt, "greedy": gr, "lm_best": best,
                            "candidates": [c for c, _ in cands]})
    total_secs = time.perf_counter() - t_start

    print(f"greedy  CER {greedy_metrics.cer:.4f}  WER {greedy_metrics.wer:.4f}")
    print(f"LM-beam CER {metrics.cer:.4f}  WER {metrics.wer:.4f}")
    print(f"{n_images} images: beam+LM decode {decode_secs:.2f}s "
          f"({n_images / max(decode_secs, 1e-9):.0f} img/s), "
          f"end-to-end {total_secs:.2f}s "
          f"({n_images / max(total_secs, 1e-9):.0f} img/s)")
    out_path = args.results_out or os.path.join(
        cfg.train.out_dir, cfg.train.exp_name, "kenlm_correction_results.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"cer": metrics.cer, "wer": metrics.wer,
                   "greedy_cer": greedy_metrics.cer,
                   "greedy_wer": greedy_metrics.wer,
                   "n_images": n_images,
                   "decode_secs": round(decode_secs, 3),
                   "decode_img_per_sec": round(n_images / max(decode_secs, 1e-9), 1),
                   "total_secs": round(total_secs, 3),
                   "samples": records}, f, indent=2, ensure_ascii=False)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
