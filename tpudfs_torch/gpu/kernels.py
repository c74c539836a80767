"""Build and bind the hand-written CUDA kernels in ``gpu/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/tpudfs_torch/`` at
the root of the checkout, at first use; ctypes binds it (pointers and the
stream as ``c_void_p``). The library's file name carries a hash of its
source, so an edited kernel is rebuilt and a stale one is never loaded.
:func:`build` starts one ``nvcc`` per source, all at once.

:func:`time_ms` times a call on the card with CUDA events (``chip_smoke.py``
uses it). Only the CUDA path imports this module: the CPU path (plain
PyTorch twins) never builds or loads anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import statistics
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpudfs_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _LL, _I, _U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
#: C signatures: library name -> {symbol: argtypes}.
_SIGNATURES = {
    "crc32c": {
        "tpudfs_crc32c_chunks": [_P, _LL, _P, _U, _P, _P],
        "tpudfs_crc32c_blocks": [_P, _LL, _LL, _P, _U, _P, _I, _P, _P],
    },
    "gf256": {"tpudfs_gf256_matmul": [_P, _LL, _I, _I, _P, _P, _P]},
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
        for symbol, argtypes in _SIGNATURES.get(name, {}).items():
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


#: Calls timed between one pair of events when the stream is held.
HELD_CALLS = 10
#: Device cycles of the sleep that holds the stream (about 3 ms), longer
#: than the host takes to enqueue HELD_CALLS calls of any kernel wrapper.
_HOLD_CYCLES = 5_000_000


def time_ms(fn, *, held: bool = True, runs: int = 25, warmup: int = 3) -> float:
    """Median over ``runs`` of the CUDA-event time of one call of ``fn`` on
    the current stream, after ``warmup`` calls.

    ``held``: a sleep kernel holds the stream while the start event,
    HELD_CALLS calls and the end event are enqueued, so the events bracket
    device time alone, back to back. Otherwise one call lies between the
    events and, where the host takes longer to launch it than the device to
    run it, the host's launch latency is part of the time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls = HELD_CALLS if held else 1
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if held:
            torch.cuda._sleep(_HOLD_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)
