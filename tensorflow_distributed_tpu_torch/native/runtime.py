"""ctypes bindings and the on-demand build of the native host runtime:
the port's own copy of the JAX package's ``native/runtime.py`` binding
of ``native/tfd_native.cc`` (a shared C++ source at the repository
root, read and never edited here).

Build: one ``g++ -O3 -shared ... -lz -pthread`` of that source into
``build/torch_native/libtfd_native.<hash>.so`` at the repository root,
the name carrying a hash of the source and the flags, so an edited
source rebuilds and a stale library is never loaded. The build runs at
the first call that needs the library, never at import; it compiles to
a per-process temporary name and renames into place, so concurrent
processes never load a half-written file.

This is host code (the idx parse and the u8 -> f32 batch gather, off the
GIL), not a GPU kernel: every entry point has the JAX package's numpy
fallback, gated by :func:`available`, for hosts without a toolchain.
:func:`loaded_path` says which library, if any, was loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(_REPO_ROOT, "native", "tfd_native.cc")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[str] = None
_load_failed = False

_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
               0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}


def library_path() -> str:
    """Where the library built from the current source lives."""
    h = hashlib.sha256(open(SRC, "rb").read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtfd_native.{h.hexdigest()[:16]}.so")


def _build(lib: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, SRC, "-lz", "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """Build if missing and dlopen the native library; None on failure
    (no source, no compiler, a failed build or load)."""
    global _lib, _lib_path, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed or not os.path.exists(SRC):
            _load_failed = True
            return None
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _load_failed = True
            return None
        c = ctypes
        lib.tfd_idx_read.restype = c.c_int
        lib.tfd_idx_read.argtypes = [
            c.c_char_p, c.POINTER(c.c_void_p), c.POINTER(c.c_int64),
            c.POINTER(c.c_int), c.POINTER(c.c_int)]
        lib.tfd_free.restype = None
        lib.tfd_free.argtypes = [c.c_void_p]
        lib.tfd_gather_u8_f32.restype = None
        lib.tfd_gather_u8_f32.argtypes = [
            c.c_void_p, c.c_int64, c.c_void_p, c.c_int64, c.c_float,
            c.c_void_p, c.c_int]
        _lib, _lib_path = lib, path
        return _lib


def available() -> bool:
    return load_library() is not None


def loaded_path() -> Optional[str]:
    """The path of the loaded library, or None when none is loaded."""
    return _lib_path


def idx_read(path: str) -> np.ndarray:
    """Read an idx(.gz) file natively (``tfd_idx_read``)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    data = ctypes.c_void_p()
    dims = (ctypes.c_int64 * 4)()
    ndim = ctypes.c_int()
    dtype = ctypes.c_int()
    rc = lib.tfd_idx_read(path.encode(), ctypes.byref(data), dims,
                          ctypes.byref(ndim), ctypes.byref(dtype))
    if rc != 0:
        raise IOError(f"tfd_idx_read({path}) failed: {rc}")
    shape = tuple(dims[i] for i in range(ndim.value))
    np_dtype = _IDX_DTYPES[dtype.value]
    n = int(np.prod(shape))
    buf = ctypes.cast(data, ctypes.POINTER(ctypes.c_uint8 * (
        n * np.dtype(np_dtype).itemsize))).contents
    # One copy out of the C buffer (freed below); writable, as
    # parse_idx's result.
    arr = np.frombuffer(buf, dtype=np_dtype).reshape(shape).copy()
    lib.tfd_free(data)
    return arr


def gather_u8_f32(src: np.ndarray, idx: np.ndarray, scale: float,
                  nthreads: int = 0) -> np.ndarray:
    """out[i] = src[idx[i]] * scale in f32, threaded in C++ (numpy
    without the library)."""
    lib = load_library()
    if lib is None:
        return src[idx].astype(np.float32) * scale
    src = np.ascontiguousarray(src)
    if src.dtype != np.uint8:
        raise TypeError(f"gather_u8_f32 takes uint8 rows, got {src.dtype}")
    item = int(np.prod(src.shape[1:]))
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.empty((len(idx), *src.shape[1:]), np.float32)
    nthreads = nthreads or min(8, os.cpu_count() or 1)
    lib.tfd_gather_u8_f32(
        src.ctypes.data_as(ctypes.c_void_p), item,
        idx.ctypes.data_as(ctypes.c_void_p), len(idx), scale,
        out.ctypes.data_as(ctypes.c_void_p), nthreads)
    return out
