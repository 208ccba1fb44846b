"""Character <-> index codec for CTC.

Reimplements the reference CTCLabelConverter semantics
(model_v1/utils/utils.py:55-87): blank = 0 is prepended to the alphabet;
encode flattens per-sample strings to 1-based indices; decode collapses
repeats, drops blanks and out-of-range ids. Includes the reference's IAM
quirk: an 87-character training alphabet gets '[' and ']' force-added as ids
88/89 (utils/utils.py:61-62 — those chars appear in train/val but not test).

Unlike the reference, encode also offers a fixed-shape padded form
(``encode_padded``) so labels batch into static [B, Lmax] device arrays.

The port's own copy of ``htr_vt_tpu/text/converter.py``, held to it by
``tests/test_torch_stem_kernels.py``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# The fork's hardcoded ASCII+Vietnamese alphabet override
# (model_v1/data/dataset.py:60-81).
VIETNAMESE_CHARSET = (
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "0123456789"
    ".,!?;: \"#&'()*+-/%=<>@[]^_`{|}~"
    "àáảãạăằắẳẵặâầấẩẫậ"
    "èéẻẽẹêềếểễệ"
    "ìíỉĩị"
    "òóỏõọôồốổỗộơờớởỡợ"
    "ùúủũụưừứửữự"
    "ỳýỷỹỵ"
    "đ"
    "ÀÁẢÃẠĂẰẮẲẴẶÂẦẤẨẪẬ"
    "ÈÉẺẼẸÊỀẾỂỄỆ"
    "ÌÍỈĨỊ"
    "ÒÓỎÕỌÔỒỐỔỖỘƠỜỚỞỠỢ"
    "ÙÚỦŨỤƯỪỨỬỮỰ"
    "ỲÝỶỸỴ"
    "Đ"
)


class CTCLabelConverter:
    def __init__(self, characters: Iterable[str]):
        chars = list(characters)
        self.dict: Dict[str, int] = {ch: i + 1 for i, ch in enumerate(chars)}
        if len(self.dict) == 87:
            # IAM: '[' and ']' occur in train/val but not test
            # (reference model_v1/utils/utils.py:61-62).
            self.dict["["], self.dict["]"] = 88, 89
        self.character: List[str] = ["[blank]"] + chars

    @property
    def num_classes(self) -> int:
        return len(self.character)

    def encode(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Flattened encode, mirroring the reference API: returns
        (concatenated int32 indices, int32 per-sample lengths)."""
        lengths = np.asarray([len(s) for s in texts], np.int32)
        flat = np.asarray([self.dict[ch] for s in texts for ch in s], np.int32)
        return flat, lengths

    def encode_padded(self, texts: Sequence[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-shape encode: [B, max_len] zero-padded indices + [B] lengths.
        Labels longer than max_len are truncated (the data pipeline filters by
        feasibility before this)."""
        b = len(texts)
        out = np.zeros((b, max_len), np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, s in enumerate(texts):
            ids = [self.dict[ch] for ch in s[:max_len]]
            out[i, :len(ids)] = ids
            lengths[i] = len(ids)
        return out, lengths

    def decode(self, text_index: np.ndarray, lengths: Sequence[int]) -> List[str]:
        """Greedy-collapse decode of flattened index runs (reference
        utils/utils.py:72-86): drop repeats, blanks, and out-of-range ids."""
        text_index = np.asarray(text_index).reshape(-1)
        texts = []
        pos = 0
        n = len(self.character)
        for l in lengths:
            t = text_index[pos:pos + int(l)]
            chars = []
            for i in range(int(l)):
                if t[i] != 0 and not (i > 0 and t[i - 1] == t[i]) and t[i] < n:
                    chars.append(self.character[int(t[i])])
            texts.append("".join(chars))
            pos += int(l)
        return texts

    def decode_batch(self, indices: np.ndarray) -> List[str]:
        """Decode [B, T] per-frame argmax indices."""
        b, t = indices.shape
        return self.decode(indices.reshape(-1), [t] * b)


def alphabet_from_labels(labels: Iterable[str]) -> List[str]:
    """Sorted unique characters across labels (reference data/dataset.py:150-156)."""
    return sorted(set("".join(labels)))
