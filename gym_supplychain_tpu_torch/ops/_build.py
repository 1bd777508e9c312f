"""Build the port's CUDA sources with nvcc and load them with ctypes.

The sources in ``csrc/`` compile at first use into one shared library with
a plain C interface, for ``sm_90a`` (Hopper), with ``--fmad=false`` (the
kernels' float rules need every product rounded before it is added; a
kernel that wants FMA asks for it with ``fmaf``).  One nvcc process per
source runs at once, then one links the objects.  The library lands in
``_build/<hash of sources and flags>/``, so a changed source builds anew and
an unchanged one loads the library already built.  Nothing is compiled or
loaded when this module is imported.
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
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = _ARCH + ("-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                      "--fmad=false")

_lock = threading.Lock()
_lib = None

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    "sc_collect_launch": [_P, _I, _I, _I, _I, _P, _P, _P, _U, _U, _P, _P, _P,
                          _P],
    "sc_policy_launch": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _U, _U,
                         _I, _P, _P, _P, _P, _P, _P, _P],
    "bg_collect_launch": [_I] * 19 + [_P, _P, _P, _U, _U, _P, _P, _P],
    "ppo_update_launch": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _F, _F, _F,
                          _F, _F, _F, _P, _P, _I, _P],
    "sc_chain_bytes": [],
    "mlp_layout_ints": [],
    "ppo_layout_ints": [],
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
    nvcc, pid = nvcc_path(), os.getpid()
    objs = [out_dir / f"{f.stem}.{pid}.o" for f in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)]
            for f, o in zip(cu, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    tmp = out_dir / f"libgst_kernels.{pid}.so"
    link = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                               + out + err)
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + " ".join(link) + "\n"
                           + res.stdout + res.stderr)
    os.replace(tmp, lib)
    for o in objs:
        o.unlink()
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
