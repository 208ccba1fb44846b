"""Host ms a served batch in ``serve.decode``, the converter's greedy CTC
decode of the batch's frame ids, from the program's spans of the traced
job, over its ``serve.batch`` spans."""

from htrbench.program_spans import host_ms_per_batch


def read(rec):
    return host_ms_per_batch(rec, ("serve.decode",))
