"""Host ms a served batch in ``serve.wait``, the serving loop's one
blocking call a batch (``cli/serve.py:ServingLoop``): the wait on the
batch's own results, after the next one's decode was queued behind it.
Above 0 the card sets the pace, 0 the host does. From the program's spans
of the traced job, over its ``serve.batch`` spans; None where the program
records no ``serve.wait`` (a loop that blocks elsewhere)."""

from htrbench.program_spans import host_ms_per_batch, traced_spans


def read(rec):
    if not any(s["name"] == "serve.wait" for s in traced_spans(rec, "serve")):
        return None
    return host_ms_per_batch(rec, ("serve.wait",))
