"""The port's own binding of the native host engine
(``native/blockio.cc`` + ``native/crc32c.cc`` + ``native/gf256.cc`` +
``native/crc64.cc``), the C++ path the reference's ``checksum``,
``erasure`` and ``blockstore`` dispatch to.

At first use the four sources are compiled with ``g++`` (the flags of
``native/Makefile``) into one shared library under ``build/tpudfs_torch/``
at the root of the checkout, named by a hash of the sources, so an edited
source is rebuilt and a stale library is never loaded. Several processes
may race to build it: each writes its own temporary file and renames it
into place. A failed build raises; there is no slower path to fall back on.
Importing this module builds nothing.

Bound entries (each with explicit ``argtypes`` and ``restype``):

- ``tpudfs_blocks_read`` / ``tpudfs_blocks_read_crc``: one call preads N
  whole block files into one contiguous buffer (slot i at ``i * stride``),
  the second also returning each slot's whole-block CRC32C;
- ``tpudfs_sweep_start`` / ``_wait`` / ``_release`` / ``_stop``: the sweep
  pump, a native producer thread filling a ring of round buffers (handles
  are int64: a C ``int`` would truncate the pointer);
- ``tpudfs_crc32c`` (:func:`crc32c`) and ``tpudfs_crc32c_chunks``
  (:func:`crc32c_chunks`): SSE4.2 CRC32C of a buffer, whole or per chunk;
- ``tpudfs_gf256_matmul`` (:func:`gf256_matmul`): a GF(2^8) matrix applied
  to shard rows, RS encode and decode;
- ``tpudfs_crc64nvme`` (:func:`crc64nvme`): slice-by-8 CRC-64/NVME, the
  client's ``etag_mode="crc64"`` ETag;
- ``tpudfs_block_write`` (:func:`block_write`): chunk CRCs, temp file,
  fsync and rename of a block and its sidecar in one call;
- ``tpudfs_block_read_verify`` (:func:`block_read_verify`): pread of a
  range and the CRC check of every chunk it touches in one call.

Each of the six wrappers counts its calls in its ``calls`` attribute, as
the kernel wrappers count launches (:func:`call_counts`, :func:`reset_calls`).
ctypes releases the interpreter lock for the length of each native call.

:func:`blocks_read_plain` is the plain Python twin of the batched read,
with the same results; ``common.checksum.crc32c_plain`` and
``crc32c_chunks_plain``, ``crc64nvme_plain`` and
``common.erasure._gf_matmul_plain`` (numpy) are the plain twins of the CRC
and GF(2^8) entries.
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

from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, as_u8, crc32c_plain

REPO = Path(__file__).resolve().parents[2]
SOURCES = [REPO / "native" / name
           for name in ("blockio.cc", "crc32c.cc", "gf256.cc", "crc64.cc")]
BUILD_DIR = REPO / "build" / "tpudfs_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra"]

_P, _U64, _I64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
_SIZE, _STR = ctypes.c_size_t, ctypes.c_char_p
#: Status codes of the block entries besides -errno (``native/blockio.cc``).
EBADMETA = -200001
ECORRUPT = -200002
ENOMETA = -200003
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
    "tpudfs_gf256_matmul": (None, [_P, _SIZE, _SIZE, _P, _SIZE, _P]),
    "tpudfs_crc64nvme": (_U64, [_U64, _P, _SIZE]),
    "tpudfs_block_write": (_I64, [_STR, _STR, _P, _U64, ctypes.c_uint32, _P]),
    "tpudfs_block_read_verify": (_I64, [_STR, _STR, _U64, _U64, _P,
                                        ctypes.c_int, ctypes.c_uint32]),
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
            f"cannot run g++ to build the native host engine: {e}") from None
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building the native host engine:\n"
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


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of a bytes-like object, a numpy array or a CPU tensor,
    continuing from ``crc``; a contiguous buffer passes by pointer."""
    buf, handle = as_u8(data), lib()
    crc32c.calls += 1
    return int(handle.tpudfs_crc32c(crc & 0xFFFFFFFF, buf.ctypes.data,
                                    len(buf)))


def crc32c_chunks(data, chunk: int = CHECKSUM_CHUNK_SIZE) -> np.ndarray:
    """Per-chunk CRC32C (uint32, the last chunk may be short) of a
    bytes-like object, a numpy array or a CPU tensor, in one native call."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    buf, handle = as_u8(data), lib()
    out = np.empty(-(-len(buf) // chunk), dtype=np.uint32)
    crc32c_chunks.calls += 1
    if len(buf):
        handle.tpudfs_crc32c_chunks(buf.ctypes.data, len(buf), chunk,
                                    out.ctypes.data)
    return out


def crc64nvme(data, crc: int = 0) -> int:
    """CRC-64/NVME of a bytes-like object, a numpy array or a CPU tensor,
    continuing from ``crc``."""
    buf, handle = as_u8(data), lib()
    crc64nvme.calls += 1
    return int(handle.tpudfs_crc64nvme(crc & 0xFFFFFFFFFFFFFFFF,
                                       buf.ctypes.data, len(buf)))


def gf256_matmul(mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """``out[r] = xor_c mat[r, c] * shards[c]`` over GF(2^8): a (rows,
    cols) uint8 matrix applied to (cols, n) uint8 shard rows."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    rows, cols = mat.shape
    if shards.ndim != 2 or shards.shape[0] != cols:
        raise ValueError(f"a ({rows}, {cols}) matrix cannot take shards of "
                         f"shape {shards.shape}")
    out = np.empty((rows, shards.shape[1]), dtype=np.uint8)
    row_ptrs = (ctypes.c_void_p * cols)(
        *(shards.ctypes.data + c * shards.strides[0] for c in range(cols)))
    out_ptrs = (ctypes.c_void_p * rows)(
        *(out.ctypes.data + r * out.strides[0] for r in range(rows)))
    handle = lib()
    gf256_matmul.calls += 1
    handle.tpudfs_gf256_matmul(mat.ctypes.data, rows, cols, row_ptrs,
                               shards.shape[1], out_ptrs)
    return out


def block_write(data_path: str, meta_path: str, data,
                chunk: int) -> np.ndarray:
    """Chunk CRCs, then ``<path>.tmp``, fsync and rename for the block and
    its sidecar; returns the chunk CRCs. Raises OSError on -errno."""
    buf, handle = as_u8(data), lib()
    out = np.empty(-(-len(buf) // chunk), dtype=np.uint32)
    block_write.calls += 1
    rc = handle.tpudfs_block_write(data_path.encode(), meta_path.encode(),
                                   buf.ctypes.data, len(buf), chunk,
                                   out.ctypes.data if len(out) else None)
    if rc < 0:
        raise OSError(-rc, os.strerror(-rc), data_path)
    return out


def block_read_verify(data_path: str, meta_path: str, offset: int,
                      length: int, out_ptr: int, chunk: int) -> int:
    """pread ``length`` bytes at ``offset`` into ``out_ptr`` after checking
    the CRC of every chunk the range touches against the sidecar, whose
    chunk size must be ``chunk``. Returns the bytes copied (the range is cut
    at the end of the block), or :data:`EBADMETA`, :data:`ECORRUPT`,
    :data:`ENOMETA` or -errno."""
    handle = lib()
    block_read_verify.calls += 1
    return int(handle.tpudfs_block_read_verify(
        data_path.encode(), meta_path.encode(), offset, length, out_ptr, 1,
        chunk))


#: The wrappers that count their calls.
ENGINE = (crc32c, crc32c_chunks, crc64nvme, gf256_matmul, block_write,
          block_read_verify)


def call_counts() -> dict[str, int]:
    return {fn.__name__: fn.calls for fn in ENGINE}


def reset_calls() -> None:
    for fn in ENGINE:
        fn.calls = 0


reset_calls()


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
            crcs[i] = crc32c_plain(data)
    return sizes, crcs
