"""Dataset list handling.

Reads the reference's ``.ln`` index format (one image filename per line,
joined to a data root; label = sibling ``.txt`` file with whitespace
collapsed — reference data/dataset.py:98-101,138-147) and builds the
data-derived alphabet (:150-156).

The port's own copy of ``htr_vt_tpu/data/lists.py``, held to it by
``tests/test_torch_stem_kernels.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence


def read_list_file(list_path: str, data_root: str) -> List[str]:
    with open(list_path, "r") as f:
        names = [ln.strip() for ln in f if ln.strip()]
    return [data_root + n for n in names]


def read_label(image_path: str) -> str:
    txt = os.path.splitext(image_path)[0] + ".txt"
    with open(txt, "r") as f:
        raw = f.read()
    return " ".join(raw.split())  # collapse linebreaks/whitespace runs


@dataclass
class LineIndex:
    """Paths + labels + alphabet for one split."""

    paths: List[str]
    labels: List[str]
    alphabet: List[str]  # sorted unique characters (index order = codec order)

    @classmethod
    def from_list_file(cls, list_path: str, data_root: str,
                       alphabet: Optional[Sequence[str]] = None,
                       max_label_len: Optional[int] = None,
                       keep_shorter: bool = True) -> "LineIndex":
        paths = read_list_file(list_path, data_root)
        labels = [read_label(p) for p in paths]
        if max_label_len is not None:
            # Reference mln filter (data/dataset.py:82-86).
            sel = [i for i, l in enumerate(labels)
                   if (len(l) <= max_label_len if keep_shorter else len(l) >= max_label_len)]
            paths = [paths[i] for i in sel]
            labels = [labels[i] for i in sel]
        if alphabet is None:
            alphabet = sorted(set("".join(labels)))
        return cls(paths=paths, labels=labels, alphabet=list(alphabet))

    def __len__(self) -> int:
        return len(self.paths)
