"""One run of one cell of ``BENCHMARK.json``.

    python3 -m htrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernel library, weights and data made from the seed,
the cell's shapes warmed), then ``--seconds`` of the cell's window, then
the check against the plain reference. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number the check compared, with its limit. The same
numbers end standard error. Without a CUDA device, or with fewer than the
cell asks for, the run exits 2 and prints no result; it exits 3 if JAX or
the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

from htrbench import guard  # noqa: E402
from htrbench.manifest import ROOT, Bench  # noqa: E402

# Caches the program or its libraries may write, at fixed paths inside the
# checkout (the kernel library itself builds into build/htr_vt_torch/).
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton"}
THREADS = 4


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            overrides: Optional[dict] = None, t_start: float = T_START,
            bench: Optional[Bench] = None) -> dict:
    """Run the cell once on ``device`` and return the result object (the
    last line's keys). ``overrides`` (tests) merge into the configuration
    and the traffic."""
    import torch

    from htrbench import common

    bench = bench or Bench()
    cell = bench.cell(workload, overrides)
    ctx = common.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                         device=torch.device(device), t_start=t_start)
    out = bench.driver(cell).run(ctx)
    correct = all(c["value"] <= c["limit"] for c in out.checks.values())
    if trace:
        metrics = {}
        for m in bench.per_layer(workload):
            value = bench.reader(m["name"])(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(workload)}
    ctx_dev = torch.device(device)
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if ctx_dev.type == "cuda" else ctx_dev.type,
                         "kind": (torch.cuda.get_device_name(ctx_dev)
                                  if ctx_dev.type == "cuda" else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": int(out.memory_peak_bytes)}}
    if trace:
        from htrbench.trace import breakdown
        red = out.record.get("trace", {})
        result["device"].update(busy_s=red.get("busy_s", 0.0), window_s=red.get("window_s", 0.0))
        result["breakdown"] = breakdown(red) if red else {"device_ops": [], "idle_gaps": []}
    result["compared"] = out.checks
    return result


def main(argv=None) -> int:
    args = _args(argv)
    guard.check("start")
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    import torch

    bench = Bench()
    chips = bench.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"htrbench: {args.workload} needs {chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                     bench=bench)
    guard.check("after the window")
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; then the result as the last line of standard output."""
    for name, c in result["compared"].items():
        print(f"htrbench: compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
