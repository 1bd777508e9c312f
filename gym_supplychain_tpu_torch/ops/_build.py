"""Build the port's CUDA sources with nvcc and load them with ctypes.

The sources in ``csrc/`` compile at first use into one shared library with
a plain C interface, for ``sm_90a`` (Hopper), with ``--fmad=false`` (the
kernels' float rules need every product rounded before it is added).  The
library lands in ``_build/<hash of sources and flags>/``, so a changed
source builds anew and an unchanged one loads the library already built.
Nothing is compiled or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "nvcc_path", "library", "check"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false")

_lock = threading.Lock()
_lib = None

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {
    "sc_collect_launch": [_P, _I, _I, _I, _I, _P, _P, _P, _U, _U, _P, _P, _P,
                          _P],
    "bg_collect_launch": [_I] * 19 + [_P, _P, _P, _U, _U, _P, _P, _P],
    "sc_chain_bytes": [],
}


def nvcc_path() -> str:
    """nvcc from PyTorch's CUDA_HOME, else from PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (neither under CUDA_HOME nor on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _build() -> Path:
    cu, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libgst_kernels.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libgst_kernels.{os.getpid()}.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                           + res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gst_error_string.argtypes = [ctypes.c_int]
            lib.gst_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch entry returned a nonzero error code."""
    if code != 0:
        msg = library().gst_error_string(code).decode()
        raise RuntimeError(f"{what}: launch failed ({code}): {msg}")
