"""On-demand build + ctypes loading of the native C++ library.

The shared object is compiled once (g++ -O3) into the git-ignored
``build/htr_vt_torch_native/`` at the repository root and loaded with
ctypes; everything degrades to pure-Python fallbacks when no compiler is
present (e.g. stripped inference containers). This is host code: the n-gram
scorer and the edit distance run on the CPU, beside the card.

The port's own copy of ``htr_vt_tpu/native/build.py``, with two changes:
the library is built outside the package, and it is linked beside its
target and renamed into place, so that a concurrent loader never sees a
half-written file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_NATIVE_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _NATIVE_DIR.parent.parent / "build" / "htr_vt_torch_native"
_LIB_PATH = _BUILD_DIR / "libhtrvt_native.so"
_SOURCES = ["editdistance.cpp", "ngram_lm.cpp"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    srcs = [str(_NATIVE_DIR / s) for s in _SOURCES if (_NATIVE_DIR / s).exists()]
    if not srcs:
        return False
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
            tmp = Path(tmpdir) / _LIB_PATH.name
            cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *srcs,
                   "-o", str(tmp)]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        return False


def _stale() -> bool:
    if not _LIB_PATH.exists():
        return True
    lib_mtime = _LIB_PATH.stat().st_mtime
    return any((_NATIVE_DIR / s).exists() and (_NATIVE_DIR / s).stat().st_mtime > lib_mtime
               for s in _SOURCES)


def load_native() -> Optional[ctypes.CDLL]:
    """Return the loaded CDLL, building it first if needed; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        if _tried and not _stale():
            return _lib
        _tried = True
        if _stale() and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        _configure(lib)
        _lib = lib
        return _lib


def _configure(lib: ctypes.CDLL) -> None:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.htrvt_levenshtein_u32.restype = ctypes.c_int64
    lib.htrvt_levenshtein_u32.argtypes = [u32p, ctypes.c_int64, u32p, ctypes.c_int64]
    lib.htrvt_levenshtein_batch_u32.restype = None
    lib.htrvt_levenshtein_batch_u32.argtypes = [u32p, i64p, u32p, i64p,
                                                ctypes.c_int64, i64p]
    if hasattr(lib, "htrvt_ngram_load"):
        lib.htrvt_ngram_load.restype = ctypes.c_void_p
        lib.htrvt_ngram_load.argtypes = [ctypes.c_char_p]
        lib.htrvt_ngram_free.restype = None
        lib.htrvt_ngram_free.argtypes = [ctypes.c_void_p]
        lib.htrvt_ngram_score.restype = ctypes.c_double
        lib.htrvt_ngram_score.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.htrvt_ngram_order.restype = ctypes.c_int
        lib.htrvt_ngram_order.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "htrvt_ngram_save"):
        lib.htrvt_ngram_save.restype = ctypes.c_int
        lib.htrvt_ngram_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    if hasattr(lib, "htrvt_ngram_cond"):
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.htrvt_ngram_cond.restype = ctypes.c_double
        lib.htrvt_ngram_cond.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_char_p]
        lib.htrvt_ngram_index.restype = ctypes.c_void_p
        lib.htrvt_ngram_index.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_char_p),
                                          ctypes.c_int]
        lib.htrvt_ngram_cond_ids.restype = None
        lib.htrvt_ngram_cond_ids.argtypes = [
            ctypes.c_void_p, i32p, ctypes.c_int, ctypes.c_int, i32p,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        lib.htrvt_ngram_index_free.restype = None
        lib.htrvt_ngram_index_free.argtypes = [ctypes.c_void_p]
