"""Host ms a served batch with nothing queued for the device, from the
program's spans of the traced job: routing, loading, stacking, padding,
the H2D copy and decoding, the calibration's loads and stacks included,
over the job's ``serve.batch`` spans."""

from htrbench.program_spans import host_ms_per_batch


def read(rec):
    return host_ms_per_batch(rec, ("serve.route", "serve.load", "serve.stack", "serve.pad",
                                   "eval.h2d", "serve.decode"))
