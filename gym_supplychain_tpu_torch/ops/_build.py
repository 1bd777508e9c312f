"""Build the port's CUDA sources with nvcc and load them with ctypes.

The sources in ``csrc/`` compile at first use into one shared library with
a plain C interface, for ``sm_90a`` (Hopper), with ``--fmad=false`` (the
kernels' float rules need every product rounded before it is added; a
kernel that wants FMA asks for it with ``fmaf``).  One nvcc process per
source runs at once, then one links the objects.  The library lands in
``_build/<hash of sources and flags>/``, so a changed source builds anew and
an unchanged one loads the library already built, beside ptxas's resource
report of each source (``ptxas_report``).  Nothing is compiled or loaded
when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "nvcc_path", "library", "check", "ptxas_report"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = _ARCH + ("-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                      "--fmad=false", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_lib_dir = None

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    # the policy lane kernel's entry: K1 `policy`/`policy_eps`, K4
    # (lane0, the global index of the first lane, after the key)
    "sc_policy_lane_launch": [_P, _I, _P, _P] + [_I] * 8 + [_P, _P, _P, _U,
                                                           _U, _U, _I]
                             + [_P] * 7,
    # the lane-group kernel's entries (LN_ENTRY_ARGS): K5, K1, K6a
    **{name: [_P] + [_I] * 10 + [_P, _P, _P, _U, _U, _P, _P, _P, _P]
       for name in ("sc_dense_launch", "sc_lane_launch", "sc_episode_launch")},
    "bg_collect_launch": [_I] * 27 + [_P, _P, _P, _U, _U, _P, _P, _P],
    "bg_episode_launch": [_I] * 12 + [_P] * 5,
    "ppo_update_launch": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _F, _F,
                          _F, _F, _F, _F, _P, _P, _I, _P],
    # the bf16 mode's entry takes its kernel (0 wgmma, 1 mma.sync) and the
    # wgmma instance, (H, hidden layers, obs rows, head rows), last
    "ppo_update_bf16_launch": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _F,
                               _F, _F, _F, _F, _F, _P, _P, _I, _P, _I, _I,
                               _I, _I, _I],
    "ppo_bf16_smem_bytes": [_I, _I, _I, _I],
    # the episode-table draw: descriptor, its words, T, B, R, P, K, lane0,
    # the key, float64, the tables, the stream
    "episode_tables_launch": [_P] + [_I] * 6 + [_U, _U, _U, _I, _P, _P, _P],
    "dn_chain_bytes": [],
    "dn_edges_bytes": [],
    "mlp_layout_ints": [],
    "ppo_layout_ints": [],
    "ppo_kernel_consts": [_P],
    "ppo_bf16_kernel_consts": [_P],
    "ppo_bf16_mma_consts": [_P],
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
    for f, cmd, p, (out, err) in zip(cu, cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                               + out + err)
        (out_dir / f"{f.stem}.ptxas.txt").write_text(out + err)
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
    global _lib, _lib_dir
    with _lock:
        if _lib is None:
            path = _build()
            lib = ctypes.CDLL(str(path))
            _lib_dir = path.parent
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gst_error_string.argtypes = [ctypes.c_int]
            lib.gst_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def ptxas_report(kernel: str):
    """ptxas's resource report of the built library's entry functions named
    ``kernel`` (template instances as ``name<args>``): a list of dicts with
    ``function``, ``registers``, ``spill_stores``, ``spill_loads`` and
    ``stack`` (bytes a thread)."""
    library()
    rows, cur = [], None
    for path in sorted(_lib_dir.glob("*.ptxas.txt")):
        for ln in path.read_text().splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                cur = _demangle(m.group(1))
                if cur.split("<")[0] == kernel:
                    rows.append(dict(function=cur, registers=None,
                                     spill_stores=0, spill_loads=0, stack=0))
                continue
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                cur = _demangle(m.group(1))
            if not rows or rows[-1]["function"] != cur:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads", ln)
            if m:
                rows[-1].update(stack=int(m[1]), spill_stores=int(m[2]),
                                spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                rows[-1]["registers"] = int(m[1])
    return rows


def _demangle(name: str) -> str:
    """``_Z15sc_dense_kernelILi16ELi10EEv...`` -> ``sc_dense_kernel<16,10>``
    (``_ZL...`` for a ``static`` kernel alike); a plain C++ name without
    template arguments keeps its base name."""
    m = re.match(r"_ZL?(\d+)", name)
    if not m:
        return name
    n = int(m[1])
    base = name[m.end():m.end() + n]
    rest = name[m.end() + n:]
    if rest.startswith("I"):
        args = re.match(r"I((?:Li-?\d+E)+)E", rest)
        if args:
            return base + "<" + ",".join(
                re.findall(r"Li(-?\d+)E", args[1])) + ">"
    return base


def check(code: int, what: str) -> None:
    """Raise if a launch entry returned a nonzero error code."""
    if code != 0:
        msg = library().gst_error_string(code).decode()
        raise RuntimeError(f"{what}: launch failed ({code}): {msg}")
