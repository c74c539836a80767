"""CRC32C checksums — the port's own copy of ``tpudfs/common/checksum.py``
(tables, per-chunk CRC, GF(2) combine).

CRC32C = Castagnoli, reflected polynomial 0x82F63B78, init/final 0xFFFFFFFF.
At rest every block carries one CRC32C per 512-byte chunk in its ``.meta``
sidecar, and the whole-block CRC is recorded at CompleteFile.

:func:`crc32c` and :func:`crc32c_chunks` run the native host engine
(``native/crc32c.cc``, SSE4.2 ``crc32q``, through ``common.native``, which
builds it at first use and raises when it cannot), as the reference does
whenever its library is built. A contiguous buffer passes by pointer, with
no copy. Their numpy bodies stay as the plain twins
:func:`crc32c_plain` and :func:`crc32c_chunks_plain`, which the tests and
``native.blocks_read_plain`` hold the engine against; ``crc32c_plain``
folds the per-chunk CRCs with the vectorized combine table, one numpy pass
a 64 MiB piece.

:func:`crc64nvme` (CRC-64/NVME, the DFS client's ``etag_mode="crc64"``
ETag) runs ``native/crc64.cc`` through the same engine; its plain twin is
:func:`crc64nvme_plain`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

#: At-rest checksum granularity (bytes per sidecar entry).
CHECKSUM_CHUNK_SIZE = 512

_POLY = 0x82F63B78
#: Chunks per numpy gather in ``crc32c_chunks`` (bounds the uint32
#: contribution temporary to 16 MiB whatever the buffer size).
_GATHER_CHUNKS = 8192


@lru_cache(maxsize=1)
def _byte_table() -> np.ndarray:
    """t0[b] = CRC register after absorbing byte b into a zero register."""
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = np.where(c & 1, (c >> 1) ^ np.uint32(_POLY), c >> 1)
    return c


def _step(regs: np.ndarray, t0: np.ndarray) -> np.ndarray:
    """Advance CRC registers by one zero byte."""
    return t0[regs & 0xFF] ^ (regs >> np.uint32(8))


@lru_cache(maxsize=8)
def contrib_table(n: int) -> tuple[np.ndarray, int]:
    """Positional contribution table for an ``n``-byte message.

    ``table[i, b]`` (uint32) is the final-register contribution of byte
    value ``b`` at position ``i`` with a zero initial register;
    ``inv_contrib`` is the contribution of the 0xFFFFFFFF initial register::

        crc = 0xFFFFFFFF ^ inv_contrib ^ XOR_i table[i, data[i]]
    """
    t0 = _byte_table()
    rows = np.empty((n, 256), dtype=np.uint32)
    regs = t0.copy()  # contribution of the last byte (position n-1)
    rows[n - 1] = regs
    for i in range(n - 2, -1, -1):
        regs = _step(regs, t0)
        rows[i] = regs
    inv_arr = np.array([0xFFFFFFFF], dtype=np.uint32)
    for _ in range(n):
        inv_arr = _step(inv_arr, t0)
    return rows, int(inv_arr[0])


def as_u8(data) -> np.ndarray:
    """The bytes of a bytes-like object, a numpy array or a CPU tensor as
    a contiguous uint8 array: a view where the input is contiguous, a
    copy otherwise. A CUDA tensor raises."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    if hasattr(data, "untyped_storage"):  # a torch tensor
        import torch

        return data.detach().contiguous().reshape(-1).view(torch.uint8) \
            .numpy()
    return np.frombuffer(data, dtype=np.uint8)


def _chunk_crcs(arr: np.ndarray, chunk: int) -> np.ndarray:
    """(nchunks, chunk) uint8 -> (nchunks,) uint32 CRCs of full chunks."""
    rows, inv = contrib_table(chunk)
    pos = np.arange(chunk)[None, :]
    out = np.empty(arr.shape[0], dtype=np.uint32)
    for lo in range(0, arr.shape[0], _GATHER_CHUNKS):
        part = arr[lo : lo + _GATHER_CHUNKS]
        out[lo : lo + len(part)] = np.bitwise_xor.reduce(rows[pos, part], axis=1)
    return out ^ np.uint32(inv) ^ np.uint32(0xFFFFFFFF)


def crc32c_chunks(data, chunk: int = CHECKSUM_CHUNK_SIZE) -> np.ndarray:
    """Per-chunk CRC32C (uint32 array), as stored in the ``.meta`` sidecar;
    the last chunk may be short. One native call."""
    from tpudfs_torch.common import native

    return native.crc32c_chunks(data, chunk)


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data``, optionally continuing from a previous ``crc``.
    One native call."""
    from tpudfs_torch.common import native

    return native.crc32c(data, crc)


def crc32c_chunks_plain(data, chunk: int = CHECKSUM_CHUNK_SIZE
                        ) -> np.ndarray:
    """Plain numpy twin of :func:`crc32c_chunks`."""
    buf = as_u8(data)
    n = len(buf)
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    nfull = n // chunk
    out = np.empty(-(-n // chunk), dtype=np.uint32)
    if nfull:
        out[:nfull] = _chunk_crcs(buf[: nfull * chunk].reshape(nfull, chunk),
                                  chunk)
    tail = n - nfull * chunk
    if tail:
        out[nfull] = _chunk_crcs(buf[nfull * chunk :].reshape(1, tail), tail)[0]
    return out


#: :func:`crc32c_plain` folds in pieces of this many bytes (a 64 MiB
#: block's chunk count), so a buffer of any length reuses one cached fold
#: table instead of building a table as long as itself.
_CRC_PIECE = 64 << 20


def crc32c_plain(data, crc: int = 0) -> int:
    """Plain numpy twin of :func:`crc32c`."""
    buf = as_u8(data)
    for lo in range(0, len(buf), _CRC_PIECE):
        piece = buf[lo : lo + _CRC_PIECE]
        whole = crc32c_fold(crc32c_chunks_plain(piece), len(piece),
                            CHECKSUM_CHUNK_SIZE)
        crc = crc32c_combine(crc, whole, len(piece))
    return crc & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# CRC concatenation (zlib crc32_combine ported to the Castagnoli polynomial)
# ---------------------------------------------------------------------------


def _gf2_matrix_times(mat, vec: int) -> int:
    total = 0
    i = 0
    while vec:
        if vec & 1:
            total ^= mat[i]
        vec >>= 1
        i += 1
    return total


def _gf2_matrix_square(mat) -> list[int]:
    return [_gf2_matrix_times(mat, m) for m in mat]


@lru_cache(maxsize=64)
def _zero_operator(len2: int) -> tuple[int, ...]:
    """GF(2) matrix advancing a CRC register across ``len2`` zero bytes."""
    odd = [_POLY] + [1 << i for i in range(31)]  # one zero bit
    even = _gf2_matrix_square(odd)  # two bits
    odd = _gf2_matrix_square(even)  # four bits
    result = [1 << i for i in range(32)]  # identity
    n = len2
    while n:
        even = _gf2_matrix_square(odd)  # next power-of-two bytes
        if n & 1:
            result = [_gf2_matrix_times(even, r) for r in result]
        odd = even
        n >>= 1
    return tuple(result)


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32C of A+B given crc32c(A), crc32c(B), and len(B)."""
    if len2 == 0:
        return crc1 & 0xFFFFFFFF
    op = _zero_operator(len2)
    return (_gf2_matrix_times(op, crc1 & 0xFFFFFFFF) ^ crc2) & 0xFFFFFFFF


@lru_cache(maxsize=16)
def combine_fold_table(chunk_len: int, n: int) -> np.ndarray:
    """(n, 32) uint32 table folding n equal-length chunk CRCs in one shot:
    ``D[i, b]`` is the contribution of bit ``b`` of chunk i's CRC to the CRC
    of the n-chunk concatenation (columns of ``M^(n-1-i)``, M = advance
    across ``chunk_len`` zero bytes), so
    ``crc(concat) = XOR_{i, b set} D[i, b]``."""
    m = np.array(_zero_operator(chunk_len), dtype=np.uint32)
    bit_idx = np.arange(32, dtype=np.uint32)[None, :]
    out = np.empty((n, 32), dtype=np.uint32)
    p = np.uint32(1) << np.arange(32, dtype=np.uint32)  # identity columns
    out[n - 1] = p
    for i in range(n - 2, -1, -1):
        sel = ((p[:, None] >> bit_idx) & 1).astype(bool)
        p = np.bitwise_xor.reduce(np.where(sel, m[None, :], np.uint32(0)), axis=1)
        out[i] = p
    out.setflags(write=False)
    return out


def crc32c_fold(crcs, total_len: int, chunk_len: int) -> int:
    """Whole-buffer CRC32C from the per-chunk CRCs of a ``total_len``-byte
    buffer chunked at ``chunk_len`` (the last chunk may be short)."""
    arr = np.asarray(crcs, dtype=np.uint32)
    full = total_len // chunk_len
    crc = crc32c_combine_chunks(arr[:full], chunk_len)
    tail = total_len - full * chunk_len
    if tail:
        crc = crc32c_combine(crc, int(arr[full]), tail)
    return crc


def crc32c_combine_chunks(crcs, chunk_len: int, crc: int = 0) -> int:
    """CRC of the concatenation of n equal-length chunks from their
    per-chunk CRCs (vectorized; one table fold)."""
    arr = np.asarray(crcs, dtype=np.uint32)
    n = int(arr.shape[0])
    if n == 0:
        return crc & 0xFFFFFFFF
    d = combine_fold_table(chunk_len, n)
    sel = ((arr[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1).astype(bool)
    total = int(np.bitwise_xor.reduce(np.where(sel, d, np.uint32(0)), axis=(0, 1)))
    if crc:
        total = crc32c_combine(crc, total, n * chunk_len)
    return total


# ---------------------------------------------------------------------------
# CRC-64/NVME
# ---------------------------------------------------------------------------

_POLY64 = 0x9A6C9329AC4BC9B5


@lru_cache(maxsize=1)
def _crc64_table() -> tuple[int, ...]:
    c = np.arange(256, dtype=np.uint64)
    for _ in range(8):
        c = np.where(c & np.uint64(1), (c >> np.uint64(1)) ^ np.uint64(_POLY64),
                     c >> np.uint64(1))
    return tuple(int(v) for v in c)


def crc64nvme(data, crc: int = 0) -> int:
    """CRC-64/NVME (reflected polynomial 0x9A6C9329AC4BC9B5, init and
    xorout all ones) of ``data``, continuing from ``crc``. One native
    call."""
    from tpudfs_torch.common import native

    return native.crc64nvme(data, crc)


def crc64nvme_plain(data, crc: int = 0) -> int:
    """Plain twin of :func:`crc64nvme`: the byte-at-a-time table loop
    (about 0.1 s a MiB)."""
    t = _crc64_table()
    reg = ~crc & 0xFFFFFFFFFFFFFFFF
    for b in as_u8(data).tolist():
        reg = t[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return ~reg & 0xFFFFFFFFFFFFFFFF
