"""Where K3b's time goes on the card: ``pool_bn_relu_bwd`` built three ways.

    python -m htr_vt_torch.cli.pool_breakdown [--reps 20]

At the flagship entry (x bf16 [128, 192, 32, 512] channels-last, g
[128, 192, 16, 512] channels-last and as contiguous NCHW), on one CUDA
device:

- ``kernel``: the kernel as it is, CUDA-event medians;
- ``clocks``: the kernel with ``clock64`` read by thread 0 of each block at
  the ends of its phases, summed over the tiles: the wait for the tile's
  load, the raw-x registers and the NCHW transpose, the normalise pass, the
  argmax pass, the gather and epilogue, the closing barrier (cycles a tile);
- ``loads_only``: the normalise, argmax and gather cut, so that a tile is
  its loads, the epilogue's float math on a zero gradient, dx's stores and
  the sums: the floor the memory traffic sets under this structure.

Each variant is a copy of ``htr_vt_torch/csrc`` under
``build/pool_breakdown/<name>/`` with ``pool_fused.cu`` patched at fixed
lines of its source; a line that is missing raises, so the tool follows the
kernel or fails. The last line of the output is a JSON record.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess

import torch

from htr_vt_torch import _build
from htr_vt_torch.ops import pool_fused

SHAPE = (128, 192, 32, 512)
PHASES = ("load wait", "raw x + NCHW transpose", "normalise", "argmax",
          "gather + epilogue", "closing barrier")
# (anchor, text put after it) in pool_bwd_kernel
CLOCKS = (
    ("  int it = 0;\n",
     "  unsigned long long ck[7] = {0, 0, 0, 0, 0, 0, 0};\n  long long ct = clock64(), cn;\n"),
    ("    hopper::mbar_wait(&bars[s], (it >> 1) & 1);\n",
     "    cn = clock64(); ck[0] += cn - ct; ct = cn; ck[6] += 1;\n"),
    ("      xr[o] = lds(xs + swz((hr + 1) * kBwdXCols + wr + 2, k));\n    }\n    __syncthreads();\n",
     "    cn = clock64(); ck[1] += cn - ct; ct = cn;\n"),
    ("      sts(xs + swz(line, k), v);\n    }\n    __syncthreads();\n",
     "    cn = clock64(); ck[2] += cn - ct; ct = cn;\n"),
    ("      sts(args + line * kLine + k * 16, arg);\n    }\n    __syncthreads();\n",
     "    cn = clock64(); ck[3] += cn - ct; ct = cn;\n"),
    ("    // The next tile's TMA writes where these threads wrote.\n",
     "    cn = clock64(); ck[4] += cn - ct; ct = cn;\n"),
    ("    hopper::fence_proxy_async();\n    __syncthreads();\n  }\n",
     "  if (tid == 0) for (int i = 0; i < 7; ++i) atomicAdd(&g_pool_clocks[i], ck[i]);\n"),
)
CLOCKS_TAIL = ("    hopper::fence_proxy_async();\n    __syncthreads();\n",
               "    cn = clock64(); ck[5] += cn - ct; ct = cn;\n")
CLOCKS_GLOBAL = (
    '#include "stem_common.cuh"\n',
    "__device__ unsigned long long g_pool_clocks[8];\n"
    'extern "C" void htrvt_pool_clocks(unsigned long long* out) {\n'
    "  cudaMemcpyFromSymbol(out, g_pool_clocks, sizeof(g_pool_clocks));\n}\n")
# (text, replacement)
LOADS_ONLY = (
    ("for (int line = slot; line < kBwdXRows * kBwdXCols; line += kBwdPixelsPerRound) {",
     "for (int line = slot; line < 0; line += kBwdPixelsPerRound) {"),
    ("if (ho0 + r < Ho && wo >= 0 && wo < W) {", "if (false) {"),
    ("for (int kw = 0; kw < 3; ++kw) {\n          const int line = r * kBwdGCols",
     "for (int kw = 0; kw < 0; ++kw) {\n          const int line = r * kBwdGCols"),
)


def _insert_after(text: str, anchor: str, extra: str) -> str:
    if text.count(anchor) != 1:
        raise RuntimeError(f"pool_breakdown: {anchor!r} is not one line of pool_fused.cu")
    return text.replace(anchor, anchor + extra)


def patched(name: str) -> str:
    """pool_fused.cu of the variant ``name``."""
    text = (_build.CSRC / "pool_fused.cu").read_text()
    if name == "clocks":
        text = _insert_after(text, *CLOCKS_GLOBAL)
        for anchor, extra in CLOCKS:
            text = _insert_after(text, anchor, extra)
        # the closing barrier's clock: after the tile loop's last barrier
        head, sep, tail = text.rpartition(CLOCKS_TAIL[0])
        text = head + sep + CLOCKS_TAIL[1] + tail
    elif name == "loads_only":
        for old, new in LOADS_ONLY:
            if text.count(old) != 1:
                raise RuntimeError(f"pool_breakdown: {old!r} is not one line of pool_fused.cu")
            text = text.replace(old, new)
    return text


def build_variant(name: str) -> ctypes.CDLL:
    root = _build.BUILD_DIR.parent / "pool_breakdown" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root / "csrc")
    (root / "csrc" / "pool_fused.cu").write_text(patched(name))
    target = root / "libhtrvt_torch_kernels.so"
    _build.build(root / "csrc", target)
    return _build.load(target)


def median_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pool_breakdown: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    b, c, h, w = SHAPE
    x = torch.randn(SHAPE, generator=gen, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    shift = 0.1 * torch.randn(c, generator=gen, device=dev)
    g_nchw = torch.randn((b, c, h // 2, w), generator=gen, device=dev).to(torch.bfloat16)
    grads = {"channels-last": g_nchw.contiguous(memory_format=torch.channels_last),
             "NCHW": g_nchw}
    record = {"device": smi, "shape": list(SHAPE)}
    default = _build.library
    try:
        for name in ("kernel", "clocks", "loads_only"):
            lib = default() if name == "kernel" else build_variant(name)
            _build.library = lambda lib=lib: lib  # the wrapper launches this build
            for layout, g in grads.items():
                run = lambda g=g: pool_fused.pool_bn_relu_bwd(g, x, scale, shift)  # noqa: E731
                entry = {"ms": median_ms(run, args.reps)}
                if name == "clocks":
                    entry.update(phase_cycles(lib, run))
                record[f"{name} {layout}"] = entry
                print(f"[{name}] g {layout}: {json.dumps(entry)}", flush=True)
    finally:
        _build.library = default
    print(json.dumps(record))


def phase_cycles(lib: ctypes.CDLL, run) -> dict:
    """Thread 0's cycles a tile in each phase over one launch of ``run``."""
    lib.htrvt_pool_clocks.argtypes = [ctypes.c_void_p]
    lib.htrvt_pool_clocks.restype = None
    buf = (ctypes.c_ulonglong * 8)()
    torch.cuda.synchronize()
    lib.htrvt_pool_clocks(buf)
    before = list(buf)
    run()
    torch.cuda.synchronize()
    lib.htrvt_pool_clocks(buf)
    got = [u - v for u, v in zip(buf, before)]
    tiles = max(got[6], 1)
    return {"cycles_per_tile": {ph: got[i] / tiles for i, ph in enumerate(PHASES)},
            "tiles": got[6]}


if __name__ == "__main__":
    main()
