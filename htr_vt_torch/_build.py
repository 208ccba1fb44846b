"""Build and load the port's CUDA kernels.

Every ``htr_vt_torch/csrc/*.cu`` is compiled by its own ``nvcc`` for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, which ``ctypes`` loads: no PyTorch
headers, so a build takes seconds. The library goes to
``build/htr_vt_torch/`` at the repository root and is rebuilt when a source
is newer. A missing ``nvcc`` or a failed build raises with the compiler's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "htr_vt_torch"
LIBRARY = BUILD_DIR / "libhtrvt_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("htr_vt_torch kernels need nvcc (the CUDA toolkit); "
                       "none on PATH or under $CUDA_HOME/bin")


def _run(procs) -> str:
    """Wait for every (cmd, Popen); raise with the output of any failure."""
    log, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(log)


def build(csrc: Path = CSRC, target: Path = LIBRARY) -> str:
    """Compile the kernels of ``csrc`` into ``target`` now; returns nvcc's
    output (the ptxas register and shared-memory report). Raises
    RuntimeError with it on failure."""
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(csrc.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=target.parent) as tmpdir:
        objects = [Path(tmpdir) / f"{src.stem}.o" for src in sources]
        compiles = []
        for src, obj in zip(sources, objects):
            cmd = [nvcc, *COMPILE_FLAGS, "-I", str(csrc), "-c", str(src),
                   "-o", str(obj)]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = _run(compiles)
        # Link beside the target and rename, so that a concurrent loader
        # never sees a half-written library.
        tmp = Path(tmpdir) / target.name
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objects)]
        log += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
        os.replace(tmp, target)
    return log


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(p.stat().st_mtime > built for p in CSRC.glob("*.cu*"))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    if _stale():
        build()
    return load(LIBRARY)


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library with its C functions' signatures set."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.htrvt_ctc_alpha, lib.htrvt_ctc_beta):
        fn.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        fn.restype = i32
    lib.htrvt_bn_stats.argtypes = [ptr] * 5 + [i64] + [i32] * 4 + [ptr]
    lib.htrvt_pool_bn_relu_fwd.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.htrvt_pool_bn_relu_bwd.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    lib.htrvt_conv3x3_fwd.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.htrvt_conv3x3_dgrad.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
    lib.htrvt_conv3x3_wgrad.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    for fn in (lib.htrvt_bn_stats, lib.htrvt_pool_bn_relu_fwd,
               lib.htrvt_pool_bn_relu_bwd, lib.htrvt_conv3x3_fwd,
               lib.htrvt_conv3x3_dgrad, lib.htrvt_conv3x3_wgrad):
        fn.restype = i32
    strides, f32 = ctypes.POINTER(i64), ctypes.c_float
    lib.htrvt_flash_fwd.argtypes = [ptr] * 6 + [strides, f32] + [i32] * 5 + [ptr]
    lib.htrvt_flash_bwd_dkv.argtypes = [ptr] * 9 + [strides, f32] + [i32] * 5 + [ptr]
    lib.htrvt_flash_bwd_dq.argtypes = [ptr] * 8 + [strides, f32] + [i32] * 5 + [ptr]
    for fn in (lib.htrvt_flash_fwd, lib.htrvt_flash_bwd_dkv, lib.htrvt_flash_bwd_dq):
        fn.restype = i32
    lib.htrvt_conv_int8.argtypes = ([ptr, i32] + [ptr] * 7 + [i32] + [i32] * 12
                                    + [ptr])
    lib.htrvt_conv_int8.restype = i32
    lib.htrvt_conv_int8_route.argtypes = [i32] * 11
    lib.htrvt_conv_int8_route.restype = i32
    lib.htrvt_conv3x3_dgrad_rows.argtypes = [i32] * 4
    lib.htrvt_conv3x3_dgrad_rows.restype = i64
    lib.htrvt_conv3x3_wgrad_splits.argtypes = [i32] * 6
    lib.htrvt_conv3x3_wgrad_splits.restype = i32
    lib.htrvt_cuda_error_string.argtypes = [i32]
    lib.htrvt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(fn: str, err: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error: a refused
    launch never runs, and a later synchronise would not report it."""
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err} "
                           f"({library().htrvt_cuda_error_string(err).decode()})")
