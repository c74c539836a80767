"""Build and bind the hand-written CUDA kernels in ``gpu/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/tpudfs_torch/`` at
the root of the checkout, at first use; ctypes binds it (pointers and the
stream as ``c_void_p``). The library's file name carries a hash of its
source, so an edited kernel is rebuilt and a stale one is never loaded.
:func:`build` starts one ``nvcc`` per source, all at once.

Only the CUDA path imports this module: the CPU path (plain PyTorch twins)
never builds or loads anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpudfs_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: C signatures: name -> (symbol, argtypes).
_SIGNATURES = {
    "crc32c": ("tpudfs_crc32c_chunks",
               [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]),
    "gf256": ("tpudfs_gf256_matmul",
              [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
}

_libs: dict[str, ctypes.CDLL] = {}
#: First use may come from several threads at once (the reader launches
#: from the event loop and from worker threads): one builds, one loads.
_load_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, started together. Returns per kernel its
    library path, build seconds (0 when it was already built) and the
    compiler's resource report (``-Xptxas -v``). Raises on any failure."""
    names = list(names or _SIGNATURES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    info = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            info[name] = {"so": str(so), "seconds": 0.0, "ptxas": ""}
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started[name] = (proc, tmp, so, time.perf_counter())
    for name, (proc, tmp, so, t0) in started.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}{err}")
        os.replace(tmp, so)
        info[name] = {"so": str(so), "seconds": time.perf_counter() - t0,
                      "ptxas": (out + err).strip()}
    return info


def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    cached = _libs.get(name)
    if cached is not None:
        return cached
    with _load_lock:
        if name in _libs:
            return _libs[name]
        so = library_path(name)
        if not so.exists():
            build([name])
        handle = ctypes.CDLL(str(so))
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(handle, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        handle.tpudfs_cuda_error_string.argtypes = [ctypes.c_int]
        handle.tpudfs_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = handle
        return handle


def check(name: str, rc: int) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib(name).tpudfs_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}: {msg}")
