"""Host ms a served batch in ``eval.h2d``, the copy of the stacked batch
from pageable host memory to the card (``train/step.py:_put``), from the
program's spans of the traced job, over its ``serve.batch`` spans."""

from htrbench.program_spans import host_ms_per_batch


def read(rec):
    return host_ms_per_batch(rec, ("eval.h2d",))
