"""CRC32C of 512-byte chunks on the GPU — port of
``tpudfs/tpu/crc32c_pallas.py``.

CRC is linear over GF(2), so the CRC of a 512-byte chunk is the XOR of fixed
per-bit contributions::

    crc(chunk) = ~( INV ^ XOR_{w<128, b<32} [bit b of word w] * WCONTRIB[b, w] )

Layout: a block of N bytes (zero-padded to a multiple of 512) is a
``(N/512, 128)`` uint32 tensor, 128 little-endian words per chunk.

:func:`crc32c_chunks_device` is the kernel wrapper: a CUDA tensor goes to
the hand-written kernel ``csrc/crc32c.cu``, a CPU tensor to the plain
PyTorch twin of the reference's ``_crc_rows`` + ``_fold_lanes``. The
whole-block GF(2) combine-fold (:func:`block_crc_device`) is plain PyTorch
on either device, as it is plain XLA outside the Pallas kernel in the
reference.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tpudfs_torch.common.checksum import (
    CHECKSUM_CHUNK_SIZE,
    combine_fold_table,
    contrib_table,
)
from tpudfs_torch.gpu import (
    device_constant,
    host_to_device,
    i64_to_u32,
    resolve_device,
    u32_to_i64,
    u32_to_numpy,
    xor_reduce,
)

WORDS_PER_CHUNK = CHECKSUM_CHUNK_SIZE // 4  # 128


@lru_cache(maxsize=1)
def word_contrib_table() -> np.ndarray:
    """(32, 128) uint32: WCONTRIB[b, w] = CRC-register contribution of bit b
    of little-endian word w of a 512-byte chunk (zero init register)."""
    rows, _ = contrib_table(CHECKSUM_CHUNK_SIZE)  # (512, 256) byte-level
    out = np.zeros((32, WORDS_PER_CHUNK), dtype=np.uint32)
    for w in range(WORDS_PER_CHUNK):
        for bit in range(32):
            out[bit, w] = rows[w * 4 + bit // 8, 1 << (bit % 8)]
    out.setflags(write=False)
    return out


@lru_cache(maxsize=1)
def inv_contrib() -> int:
    """Contribution of the 0xFFFFFFFF init register across one chunk."""
    return contrib_table(CHECKSUM_CHUNK_SIZE)[1]


def bytes_to_words(data) -> np.ndarray:
    """Zero-pad to a chunk multiple and view as (chunks, 128) uint32.

    Always writable, so ``torch.from_numpy`` takes it as it is: a zero-copy
    view when ``data`` is a writable chunk-aligned buffer (``bytearray``, a
    writable ndarray), else one padded copy. Empty input is one zero chunk.
    """
    if isinstance(data, np.ndarray):
        buf = data.reshape(-1).view(np.uint8)
    else:
        buf = np.frombuffer(data, dtype=np.uint8)
    n = len(buf)
    if n and n % CHECKSUM_CHUNK_SIZE == 0 and buf.flags.writeable:
        return buf.view("<u4").reshape(-1, WORDS_PER_CHUNK)
    padded_len = -(-max(n, 1) // CHECKSUM_CHUNK_SIZE) * CHECKSUM_CHUNK_SIZE
    out = np.zeros(padded_len, dtype=np.uint8)
    out[:n] = buf
    return out.view("<u4").reshape(-1, WORDS_PER_CHUNK)


# --------------------------------------------------------------- kernel 1


def _crc_rows(words: torch.Tensor, wcontrib: torch.Tensor) -> torch.Tensor:
    """(C, 128) int64 words -> (C, 128) per-word XORed contributions."""
    acc = torch.zeros_like(words)
    for bit in range(32):
        mask = ((words >> bit) & 1).bool()
        acc ^= torch.where(mask, wcontrib[bit][None, :], 0)
    return acc


def _fold_lanes(acc: torch.Tensor) -> torch.Tensor:
    """XOR-reduce (C, 128) over lanes via log2 pairwise folds -> (C, 1)."""
    width = acc.shape[1]
    while width > 1:
        half = width // 2
        acc = acc[:, :half] ^ acc[:, half : 2 * half]
        width = half
    return acc


def crc32c_chunks_plain(words: torch.Tensor, wcontrib: torch.Tensor,
                        inv: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (C, 128) uint32 -> (C,) uint32."""
    acc = _fold_lanes(_crc_rows(u32_to_i64(words), u32_to_i64(wcontrib)))
    return i64_to_u32(acc[:, 0] ^ inv ^ 0xFFFFFFFF)


def _crc_cuda(words: torch.Tensor, wcontrib: torch.Tensor,
              inv: int) -> torch.Tensor:
    from tpudfs_torch.gpu import kernels

    if not words.is_contiguous() or words.data_ptr() % 16:
        raise ValueError("words must be contiguous and 16-byte aligned")
    if not wcontrib.is_contiguous() or wcontrib.device != words.device:
        raise ValueError("wcontrib must be contiguous, on the words' device")
    out = torch.empty(words.shape[0], dtype=torch.int32, device=words.device)
    rc = kernels.lib("crc32c").tpudfs_crc32c_chunks(
        words.data_ptr(), words.shape[0], wcontrib.data_ptr(),
        (inv ^ 0xFFFFFFFF) & 0xFFFFFFFF, out.data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream,
    )
    kernels.check("crc32c", rc)
    return out.view(torch.uint32)


def crc32c_chunks_device(words: torch.Tensor,
                         wcontrib: torch.Tensor | None = None,
                         inv: int | torch.Tensor | None = None) -> torch.Tensor:
    """Per-chunk CRC32C of chunk words on their device ((C, 128) uint32 ->
    (C,) uint32). CUDA: the hand-written kernel (raises if it cannot
    launch); CPU: the plain twin. ``wcontrib`` / ``inv`` default to the
    port's own tables (see ``gpu.state`` for the reference's)."""
    if words.dim() != 2 or words.shape[1] != WORDS_PER_CHUNK \
            or words.dtype != torch.uint32:
        raise ValueError(f"expected (C, 128) uint32 words, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if wcontrib is None:
        wcontrib = device_constant("word_contrib_table", words.device,
                                   word_contrib_table)
    inv = inv_contrib() if inv is None else int(inv)
    if words.device.type == "cpu":
        return crc32c_chunks_plain(words, wcontrib, inv)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    out = _crc_cuda(words, wcontrib, inv)
    crc32c_chunks_device.launches += 1
    return out


#: Kernel launches (CUDA path only) since the last reset.
crc32c_chunks_device.launches = 0


def crc32c_chunks_torch(data, device: torch.device | str | None = None
                        ) -> np.ndarray:
    """Host convenience: bytes -> per-512B-chunk CRCs via the device path
    (the padded layout of :func:`bytes_to_words`)."""
    words = host_to_device(bytes_to_words(data), resolve_device(device))
    return u32_to_numpy(crc32c_chunks_device(words))


# ------------------------------------------------------ whole-block fold


def fold_table_device(cpb: int, device: torch.device) -> torch.Tensor:
    """The (cpb, 32) combine-fold table on ``device`` (uploaded once)."""
    return device_constant(("combine_fold_table", cpb), device,
                           lambda: combine_fold_table(CHECKSUM_CHUNK_SIZE, cpb))


def _fold(crcs: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    """(B, cpb) int64 chunk CRCs + (cpb, 32) uint32 table -> (B,) int64
    whole-block CRCs: XOR of D[i, b] over every set bit b of chunk i."""
    shifts = torch.arange(32, device=crcs.device)
    bits = ((crcs[..., None] >> shifts) & 1).bool()
    contrib = torch.where(bits, u32_to_i64(fold)[None], 0)
    return xor_reduce(contrib.reshape(crcs.shape[0], -1))


def block_crc_device(words: torch.Tensor, *,
                     wcontrib: torch.Tensor | None = None,
                     inv: int | torch.Tensor | None = None,
                     fold: torch.Tensor | None = None) -> torch.Tensor:
    """Whole-(padded-)block CRC32C on the words' device: a 0-d uint32
    tensor, with no host readback. Computed over the zero-padded chunk
    stream; equals the stored whole-block CRC only when the block length is
    a chunk multiple."""
    n = words.shape[0]
    if n == 0:  # crc32c(b"") == 0
        return i64_to_u32(torch.zeros((), dtype=torch.int64, device=words.device))
    crcs = u32_to_i64(crc32c_chunks_device(words, wcontrib, inv))
    if fold is None:
        fold = fold_table_device(n, words.device)
    return i64_to_u32(_fold(crcs[None, :], fold)[0])


def batch_block_crc_device(words: torch.Tensor, nblocks: int, *,
                           fold: torch.Tensor | None = None) -> torch.Tensor:
    """Whole-block CRC32C of ``nblocks`` equal-chunk-count blocks laid out
    contiguously in one (nblocks*cpb, 128) tensor -> (nblocks,) uint32: one
    kernel launch for the batch's chunks, then one fold with a shared
    (cpb, 32) table."""
    total = words.shape[0]
    if total == 0 or nblocks == 0:
        return i64_to_u32(torch.zeros(nblocks, dtype=torch.int64,
                                      device=words.device))
    cpb = total // nblocks
    crcs = u32_to_i64(crc32c_chunks_device(words)).reshape(nblocks, cpb)
    if fold is None:
        fold = fold_table_device(cpb, words.device)
    return i64_to_u32(_fold(crcs, fold))


def verify_block_device(words: torch.Tensor,
                        expected: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: True iff every chunk CRC matches ``expected``
    (uint32, computed over the same padded layout)."""
    actual = crc32c_chunks_device(words)
    return (u32_to_i64(actual) == u32_to_i64(expected)).all()

