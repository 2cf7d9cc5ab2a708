"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source exports a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_ext/`` at the repository root, then loaded with ctypes.
The library name carries a hash of the source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header
rebuilds instead of loading a stale library. Nothing is
built at import time: the first kernel launch (or :func:`load`) builds.

Sources stay free of PyTorch's headers on purpose: a plain C interface
compiles in seconds, where a source that includes ``torch/extension.h``
takes minutes, and every fresh checkout builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (library, compiler output of the build, or "" when cached)
_LOADED: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def nvcc_path() -> str:
    """The nvcc that builds the kernels: PATH first, then the CUDA home
    that ``torch.utils.cpp_extension`` detects."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME): the port's CUDA kernels are "
        "built from source at first use and need the CUDA toolkit")


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of what the library ``name`` is built from: ``<name>.cu``,
    every header ``*.cuh`` beside it (in name order) and the nvcc flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built on first
    call in this process, or reused from ``build/torch_ext/``)."""
    if name not in _LOADED:
        src = CSRC / f"{name}.cu"
        lib_path = BUILD_DIR / f"lib{name}_{source_digest(name)}.so"
        log = ""
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True, check=False)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            os.replace(tmp, lib_path)
        _LOADED[name] = (ctypes.CDLL(str(lib_path)), log)
    return _LOADED[name][0]


def build_log(name: str) -> str:
    """What nvcc (with ``-Xptxas -v``: registers, shared memory and
    spills per kernel) printed when :func:`load` built ``name`` in this
    process; empty when the library came from the build directory."""
    load(name)
    return _LOADED[name][1]


def on_cpu(op: str, *tensors) -> bool:
    """True when every tensor is on the CPU (the plain version runs);
    False when every one is on a CUDA device (the kernel runs). ``None``
    entries (an absent bias) are skipped; a mix of devices raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{op}: tensors on {sorted(kinds)}; need all on cpu "
                     f"or all on one cuda device")


class Kernel:
    """One exported C function ``tfd_<name>`` of ``csrc/<library>.cu``
    and the count of its launches (``launches``, reset by callers that
    need to prove a run went through it). Every exported function takes
    its device pointers first and the CUDA stream last, and returns the
    CUDA error of its launch (0 = launched)."""

    def __init__(self, library: str, name: str, argtypes: Sequence):
        self.library = library
        self.name = name
        self.launches = 0
        self._argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self._fn = None

    def __call__(self, tensors: Sequence, *scalars) -> None:
        """Launch on the current stream of the first tensor's device;
        ``None`` in ``tensors`` passes a null pointer."""
        if self._fn is None:
            fn = getattr(load(self.library), f"tfd_{self.name}")
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        device = next(t for t in tensors if t is not None).device
        # The C code launches on the current device: make it the tensors'.
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._fn(*[None if t is None else t.data_ptr()
                             for t in tensors], *scalars, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {err}")
        self.launches += 1
