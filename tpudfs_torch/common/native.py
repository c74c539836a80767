"""The port's own binding of the native block I/O engine
(``native/blockio.cc`` + ``native/crc32c.cc``).

At first use the two sources are compiled with ``g++`` (the flags of
``native/Makefile``) into one shared library under ``build/tpudfs_torch/``
at the root of the checkout, named by a hash of both sources, so an edited
source is rebuilt and a stale library is never loaded. Several processes
may race to build it: each writes its own temporary file and renames it
into place. A failed build raises; there is no slower path to fall back on.

Bound entries (each with explicit ``argtypes`` and ``restype``):

- ``tpudfs_blocks_read`` / ``tpudfs_blocks_read_crc``: one call preads N
  whole block files into one contiguous buffer (slot i at ``i * stride``),
  the second also returning each slot's whole-block CRC32C;
- ``tpudfs_sweep_start`` / ``_wait`` / ``_release`` / ``_stop``: the sweep
  pump, a native producer thread filling a ring of round buffers (handles
  are int64: a C ``int`` would truncate the pointer);
- ``tpudfs_crc32c``;
- ``tpudfs_crc32c_chunks``: per-chunk CRC32C of one buffer
  (:func:`crc32c_chunks`), the collective write group's staging CRC.

:func:`blocks_read_plain` is the plain Python twin of the batched read,
with the same results; ``common.checksum.crc32c_chunks`` (numpy) is the
plain twin of :func:`crc32c_chunks`.
"""

from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c

REPO = Path(__file__).resolve().parents[2]
SOURCES = [REPO / "native" / "blockio.cc", REPO / "native" / "crc32c.cc"]
BUILD_DIR = REPO / "build" / "tpudfs_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra"]

_P, _U64, _I64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
_SIZE = ctypes.c_size_t
#: symbol -> (restype, argtypes)
_SIGNATURES = {
    "tpudfs_blocks_read": (_I64, [_P, _U64, _U64, _P, _P]),
    "tpudfs_blocks_read_crc": (_I64, [_P, _U64, _U64, _P, _P, _P]),
    "tpudfs_sweep_start": (_I64, [_P, _U64, _U64, _U64, _P, _U64, _P, _P]),
    "tpudfs_sweep_wait": (_I64, [_I64, _I64]),
    "tpudfs_sweep_release": (None, [_I64, _I64]),
    "tpudfs_sweep_stop": (None, [_I64]),
    "tpudfs_crc32c": (ctypes.c_uint32, [ctypes.c_uint32, _P, _SIZE]),
    "tpudfs_crc32c_chunks": (None, [_P, _SIZE, _SIZE, _P]),
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtpudfs_blockio-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises RuntimeError when ``g++`` fails or is missing."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES), "-lpthread"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(
            f"cannot run g++ to build the block I/O library: {e}") from None
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building the block I/O library:\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for symbol, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, symbol)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = handle
    return _lib


def c_paths(paths: list[str]):
    """A ``const char**`` array; keep it alive while native code reads it."""
    return (ctypes.c_char_p * len(paths))(*(p.encode() for p in paths))


def blocks_read(paths: list[str], stride: int, out_ptr: int, *,
                with_crc: bool) -> tuple[np.ndarray, np.ndarray | None]:
    """pread each file into slot i (``out_ptr + i * stride``, at most
    ``stride`` bytes) in one native call. Returns (sizes, crcs): sizes[i]
    is the bytes read or -errno; crcs (``with_crc``) each slot's CRC32C of
    the bytes read, 0 for a failed slot. The caller owns the buffer and
    guarantees ``len(paths) * stride`` bytes there."""
    n = len(paths)
    sizes = np.empty(n, dtype=np.int64)
    cpaths = c_paths(paths)
    if with_crc:
        crcs = np.empty(n, dtype=np.uint32)
        lib().tpudfs_blocks_read_crc(cpaths, n, stride, out_ptr,
                                     sizes.ctypes.data, crcs.ctypes.data)
        return sizes, crcs
    lib().tpudfs_blocks_read(cpaths, n, stride, out_ptr, sizes.ctypes.data)
    return sizes, None


def crc32c_chunks(data, chunk: int = CHECKSUM_CHUNK_SIZE) -> np.ndarray:
    """Per-chunk CRC32C (uint32, the last chunk may be short) of a
    bytes-like object or a contiguous numpy array, in one native call that
    runs without the interpreter lock. Same results as the numpy
    ``common.checksum.crc32c_chunks``."""
    if isinstance(data, np.ndarray):
        if not data.flags.c_contiguous:
            raise ValueError("crc32c_chunks needs a contiguous array")
        buf = data.reshape(-1).view(np.uint8)
    else:
        buf = np.frombuffer(data, dtype=np.uint8)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    out = np.empty(-(-len(buf) // chunk), dtype=np.uint32)
    if len(buf):
        lib().tpudfs_crc32c_chunks(buf.ctypes.data, len(buf), chunk,
                                   out.ctypes.data)
    return out


def blocks_read_plain(paths: list[str], stride: int, out: np.ndarray, *,
                      with_crc: bool) -> tuple[np.ndarray, np.ndarray | None]:
    """Plain Python twin of :func:`blocks_read` into the uint8 array
    ``out`` (same sizes, errno codes and CRCs)."""
    n = len(paths)
    sizes = np.empty(n, dtype=np.int64)
    crcs = np.zeros(n, dtype=np.uint32) if with_crc else None
    for i, path in enumerate(paths):
        try:
            with open(path, "rb") as f:
                data = f.read(stride)
        except OSError as e:
            sizes[i] = -(e.errno or errno.EIO)
            continue
        out[i * stride : i * stride + len(data)] = \
            np.frombuffer(data, np.uint8)
        sizes[i] = len(data)
        if crcs is not None:
            crcs[i] = crc32c(data)
    return sizes, crcs
