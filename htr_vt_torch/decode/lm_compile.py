"""Compile an ARPA n-gram model to this framework's .htlm binary format.

The reference's kenlm dependency loads both ARPA text and kenlm's own .bin
(model_window/test_with_kenlm.py:21-23). kenlm's binary layout is a private
versioned format that cannot be validated in this image (no kenlm build), so
this framework defines its own compiled form instead: the parsed backoff
table serialized verbatim (native/ngram_lm.cpp, magic "HTRVTLM1") — scores
bit-identical to the source ARPA, load time cut by the whole text-parsing
pass (measured 3.4x on a 1.2M-ngram char-5-gram; the residual cost is the
hash-table build). Every entry point that takes an ARPA path (cli/test_with_lm.py --arpa,
cli/serve.py --arpa, NgramScorer) accepts a compiled model transparently.

Usage:
    python -m htr_vt_torch.decode.lm_compile model.arpa model.htlm
    python -m htr_vt_torch.decode.lm_compile model.arpa model.htlm --verify

The port's own copy of ``htr_vt_tpu/decode/lm_compile.py``, held to it by
``tests/test_torch_port_decode_lm.py``.
"""

from __future__ import annotations

import argparse
import os
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arpa", help="input ARPA text model")
    ap.add_argument("out", help="output compiled model (.htlm)")
    ap.add_argument("--verify", action="store_true",
                    help="reload the compiled model and check a few "
                         "sentence scores against the ARPA source")
    args = ap.parse_args()

    from htr_vt_torch.decode.lm import NgramScorer

    t0 = time.perf_counter()
    scorer = NgramScorer(args.arpa)
    t_arpa = time.perf_counter() - t0
    scorer.save_binary(args.out)
    t0 = time.perf_counter()
    compiled = NgramScorer(args.out)
    t_bin = time.perf_counter() - t0
    print(f"order {scorer.order}; arpa {os.path.getsize(args.arpa):,} B "
          f"(load {t_arpa * 1e3:.1f} ms) -> htlm "
          f"{os.path.getsize(args.out):,} B (load {t_bin * 1e3:.1f} ms)")

    if args.verify:
        probes = ["a", "a b c", "the quick brown fox", "zzz unseen zzz", ""]
        for s in probes:
            a, b = scorer.score(s), compiled.score(s)
            assert abs(a - b) < 1e-6, (s, a, b)
        print(f"verify OK ({len(probes)} probe sentences match)")


if __name__ == "__main__":
    main()
