"""Build and load the port's CUDA kernels.

Every ``htr_vt_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, which ``ctypes`` loads: no
PyTorch headers, so a build takes seconds. The library goes to
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("htr_vt_torch kernels need nvcc (the CUDA toolkit); "
                       "none on PATH or under $CUDA_HOME/bin")


def build() -> str:
    """Compile the kernels now; returns nvcc's output (the ptxas register
    and shared-memory report). Raises RuntimeError with it on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile beside the target and rename, so that a concurrent loader
    # never sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return proc.stdout + proc.stderr


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
    lib.htrvt_ctc_alpha.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.htrvt_ctc_alpha.restype = i32
    lib.htrvt_cuda_error_string.argtypes = [i32]
    lib.htrvt_cuda_error_string.restype = ctypes.c_char_p
    return lib
