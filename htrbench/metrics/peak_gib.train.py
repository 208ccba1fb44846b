"""The most device memory allocated in the window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("window_peak_bytes"):
        return None
    return rec["window_peak_bytes"] / 2**30
