"""Tokenizer for the autoregressive encoder-decoder model.

Mirrors the reference EncoderDecoderTokenizer
(data/utils/encoder_decoder_tokenizer.py:5-181): vocabulary is
[<pad>, <sos>, <eos>, <unk>] + characters; training encode produces
teacher-forcing pairs (input = <sos> + text, output = text + <eos>), both
padded to a fixed length; decode strips specials. Also covers the
CTC<->ED conversion helpers (data/utils/conversion_utils.py:10-45).

The port's own copy of ``htr_vt_tpu/text/ed_tokenizer.py``, held to it by
``tests/test_torch_port_ed.py``.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

from htr_vt_torch.text.converter import CTCLabelConverter


class EDTokenizer:
    PAD, SOS, EOS, UNK = "<pad>", "<sos>", "<eos>", "<unk>"

    def __init__(self, characters: Iterable[str]):
        chars = [self.PAD, self.SOS, self.EOS, self.UNK] + list(characters)
        self.char_to_idx = {c: i for i, c in enumerate(chars)}
        self.idx_to_char = {i: c for i, c in enumerate(chars)}
        self.pad_id, self.sos_id, self.eos_id, self.unk_id = 0, 1, 2, 3
        self.vocab_size = len(chars)
        self.character = chars

    @classmethod
    def from_ctc_converter(cls, converter: CTCLabelConverter) -> "EDTokenizer":
        """Reference conversion_utils.create_encoder_decoder_tokenizer_from_ctc:
        reuse the CTC alphabet minus the blank."""
        return cls(converter.character[1:])

    def encode_for_training(self, texts: Sequence[str],
                            max_length: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (tgt_input [B,L] with <sos> prefix, tgt_output [B,L] with
        <eos> suffix, lengths [B] incl. <eos>), all pad-filled."""
        b = len(texts)
        tin = np.full((b, max_length), self.pad_id, np.int32)
        tout = np.full((b, max_length), self.pad_id, np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, text in enumerate(texts):
            ids = [self.char_to_idx.get(c, self.unk_id) for c in text][:max_length - 1]
            tin[i, 0] = self.sos_id
            tin[i, 1:1 + len(ids)] = ids
            tout[i, :len(ids)] = ids
            tout[i, len(ids)] = self.eos_id
            lengths[i] = len(ids) + 1
        return tin, tout, lengths

    def decode(self, ids: np.ndarray) -> List[str]:
        """[B, L] -> strings, stopping at <eos>, skipping other specials."""
        out = []
        for row in np.asarray(ids):
            chars = []
            for t in row:
                t = int(t)
                if t == self.eos_id:
                    break
                if t in (self.pad_id, self.sos_id, self.unk_id):
                    continue
                chars.append(self.idx_to_char.get(t, ""))
            out.append("".join(chars))
        return out

    # validate() expects the CTC converter's batch-decode name.
    decode_batch = decode
