"""The whole SAM step's share of the card's bf16 peak: the model's
operations of the window's steps (``flops.train_step_flops``, two forward
and backward passes at bs 128, no recomputed work) over the window's time."""


def read(rec):
    if rec.get("kind") != "train" or rec["window_s"] <= 0:
        return None
    return 100.0 * rec["peak_seconds"] / rec["window_s"]
