"""ctypes bindings for the native batched MT19937 table generator.

The port's copy of the JAX package's ``native`` module.  ``mt_tables.cpp``
is a host library, not a device kernel: it builds on first use with the
host ``g++`` into the package's ignored ``_build/native/`` (one file per
hash of the source and flags, written under a temporary name and renamed
into place, so concurrent processes never load a half-written library),
and ``NativeBatchRNG`` owns one NumPy-legacy-compatible MT19937 stream per
environment.  Nothing is built or loaded when this module is imported.
Where no compiler is available ``available()`` is False and
``build_error()`` says why; callers fall back to NumPy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["available", "build_error", "library_path", "NativeBatchRNG"]

_SRC = Path(__file__).resolve().parent / "mt_tables.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD / f"libmt_tables_{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> Optional[str]:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return str(e)
    if res.returncode != 0:
        return res.stderr[-2000:]
    os.replace(tmp, lib)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build_error = _build(path)
            if _build_error is not None:
                return None
        lib = ctypes.CDLL(str(path))
        lib.batch_create.restype = ctypes.c_void_p
        lib.batch_create.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_size_t]
        lib.batch_destroy.restype = None
        lib.batch_destroy.argtypes = [ctypes.c_void_p]
        for name in ("batch_randint", "batch_normal", "batch_poisson"):
            getattr(lib, name).restype = None
        lib.batch_randint.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_long, ctypes.c_void_p,
                                      ctypes.c_size_t]
        lib.batch_normal.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                     ctypes.c_double, ctypes.c_void_p,
                                     ctypes.c_size_t]
        lib.batch_poisson.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                      ctypes.c_void_p, ctypes.c_size_t]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library did not build (None when it did)."""
    _load()
    return _build_error


class NativeBatchRNG:
    """B independent NumPy-legacy MT19937 streams with batched, multithreaded
    table fills.  Stream i seeded like ``np.random.RandomState(seeds[i])``."""

    def __init__(self, seeds: Sequence[Optional[int]]):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native RNG unavailable: {_build_error}")
        self._lib = lib
        self.B = len(seeds)
        s = np.zeros(self.B, np.uint64)
        has = np.zeros(self.B, np.uint8)
        for i, seed in enumerate(seeds):
            if seed is not None:
                s[i] = np.uint64(seed)
                has[i] = 1
        self._h = lib.batch_create(s.ctypes.data, has.ctypes.data, self.B)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.batch_destroy(h)
            self._h = None

    def randint(self, low: int, high_excl: int, n: int) -> np.ndarray:
        """[B, n] int64, each row one env's randint(low, high_excl) draws."""
        out = np.empty((self.B, n), np.int64)
        self._lib.batch_randint(self._h, low, high_excl, out.ctypes.data, n)
        return out

    def normal(self, loc: float, scale: float, n: int) -> np.ndarray:
        out = np.empty((self.B, n), np.float64)
        self._lib.batch_normal(self._h, loc, scale, out.ctypes.data, n)
        return out

    def poisson(self, lam: float, n: int) -> np.ndarray:
        out = np.empty((self.B, n), np.int64)
        self._lib.batch_poisson(self._h, lam, out.ctypes.data, n)
        return out
