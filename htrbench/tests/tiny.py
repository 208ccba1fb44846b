"""Tiny CPU sizes of each cell, for the benchmark's own tests."""

MODEL = {"embed_dim": 64, "depth": 1, "num_heads": 2, "img_size": [64, 128]}
# int8 at a width whose stem convs are all A8W8 sites, as the flagship's
INT8_MODEL = dict(MODEL, embed_dim=1024, num_heads=8)
TRAIN = {"batch": 8, "width": 128, "pool_batches": 4, "trace_steps": 1,
         "label_lengths": {"fixed": 6, "n": 16}}
SERVE = {"batch": 4, "pool_lines": 8, "check_lines": 6, "check_jobs": 2}
MIX = dict(SERVE, buckets=[128, 256, 512],
           widths={"selftest": {"n": 24, "seed": 0, "px_per_char": 6, "pad": 8}})
ONE = dict(SERVE, buckets=[128], widths={"fixed": 128, "n": 16})

# float32 training: at these sizes a bf16 step's gradients sit as far from
# the float32 reference as the float8 control's (ReLU gates that flip)
TRAIN_MODEL = dict(MODEL, compute_dtype="float32")

CELLS = {
    "iam-train-512": {"model": TRAIN_MODEL, "traffic": TRAIN},
    "iam-int8-serve-512": {"model": INT8_MODEL, "traffic": ONE},
    "iam-serve-512": {"model": MODEL, "traffic": ONE},
}

# Each cell, and the serving driver over three buckets (the driver takes
# any set; no cell of BENCHMARK.json routes more than one yet).
DRY_RUNS = dict({c: (c, o) for c, o in CELLS.items()},
                **{"three buckets": ("iam-serve-512", {"model": MODEL, "traffic": MIX})})
