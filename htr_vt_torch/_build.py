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


def build() -> str:
    """Compile the kernels now; returns nvcc's output (the ptxas register
    and shared-memory report). Raises RuntimeError with it on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objects = [Path(tmpdir) / f"{src.stem}.o" for src in sources]
        compiles = []
        for src, obj in zip(sources, objects):
            cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = _run(compiles)
        # Link beside the target and rename, so that a concurrent loader
        # never sees a half-written library.
        tmp = Path(tmpdir) / LIBRARY.name
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objects)]
        log += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
        os.replace(tmp, LIBRARY)
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
    lib = ctypes.CDLL(str(LIBRARY))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.htrvt_ctc_alpha, lib.htrvt_ctc_beta):
        fn.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        fn.restype = i32
    lib.htrvt_cuda_error_string.argtypes = [i32]
    lib.htrvt_cuda_error_string.restype = ctypes.c_char_p
    return lib
