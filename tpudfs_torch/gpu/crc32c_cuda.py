"""CRC32C of 512-byte chunks on the GPU — port of
``tpudfs/tpu/crc32c_pallas.py``.

CRC is linear over GF(2), so the CRC of a 512-byte chunk is the XOR of fixed
per-bit contributions::

    crc(chunk) = ~( INV ^ XOR_{w<128, b<32} [bit b of word w] * WCONTRIB[b, w] )

and the CRC of a block of n chunks is ``XOR_i M^(n-1-i) crc(chunk i)``, M the
advance of a CRC register across 512 zero bytes.

Layout: a block of N bytes (zero-padded to a multiple of 512) is a
``(N/512, 128)`` uint32 tensor, 128 little-endian words per chunk.

Two kernel wrappers, both on ``csrc/crc32c.cu``: :func:`crc32c_chunks_device`
(per-chunk CRCs) and :func:`crc32c_blocks_device` (whole-block CRCs of
equal-length blocks, the chunk CRCs and their combine-fold in one launch).
A CUDA tensor launches the kernel; a CPU tensor runs the plain PyTorch twin
(the reference's ``_crc_rows`` + ``_fold_lanes``, then the fold with the
combine-fold table, as the reference runs it in XLA).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tpudfs_torch.common.checksum import (
    CHECKSUM_CHUNK_SIZE,
    _gf2_matrix_square,
    _gf2_matrix_times,
    _zero_operator,
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


def _check_words(words: torch.Tensor) -> None:
    if words.dim() != 2 or words.shape[1] != WORDS_PER_CHUNK \
            or words.dtype != torch.uint32:
        raise ValueError(f"expected (C, 128) uint32 words, got "
                         f"{tuple(words.shape)} {words.dtype}")


def _tables(device: torch.device, wcontrib, inv) -> tuple[torch.Tensor, int]:
    if wcontrib is None:
        wcontrib = device_constant("word_contrib_table", device,
                                   word_contrib_table)
    return wcontrib, inv_contrib() if inv is None else int(inv)


def _cuda_args(words: torch.Tensor, wcontrib: torch.Tensor,
               *tables: torch.Tensor) -> tuple:
    """Checks what the kernel takes; returns the pointers and the stream."""
    if not words.is_contiguous() or words.data_ptr() % 16:
        raise ValueError("words must be contiguous and 16-byte aligned")
    if tuple(wcontrib.shape) != (32, WORDS_PER_CHUNK):
        raise ValueError(f"wcontrib must be (32, 128), got {tuple(wcontrib.shape)}")
    for t in (wcontrib, *tables):
        if not t.is_contiguous() or t.device != words.device \
                or t.dtype != torch.uint32:
            raise ValueError("tables must be contiguous uint32 on the words' "
                             "device")
    return (words.data_ptr(), wcontrib.data_ptr(),
            *(t.data_ptr() for t in tables),
            torch.cuda.current_stream(words.device).cuda_stream)


def crc32c_chunks_device(words: torch.Tensor,
                         wcontrib: torch.Tensor | None = None,
                         inv: int | torch.Tensor | None = None) -> torch.Tensor:
    """Per-chunk CRC32C of chunk words on their device ((C, 128) uint32 ->
    (C,) uint32). CUDA: the hand-written kernel (raises if it cannot
    launch); CPU: the plain twin. ``wcontrib`` / ``inv`` default to the
    port's own tables (see ``gpu.state`` for the reference's)."""
    _check_words(words)
    wcontrib, inv = _tables(words.device, wcontrib, inv)
    if words.device.type == "cpu":
        return crc32c_chunks_plain(words, wcontrib, inv)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    out = torch.empty(words.shape[0], dtype=torch.int32, device=words.device)
    if words.shape[0] == 0:
        return out.view(torch.uint32)
    from tpudfs_torch.gpu import kernels

    w, wc, stream = _cuda_args(words, wcontrib)
    with torch.cuda.device(words.device):  # the stream's card is current
        rc = kernels.lib("crc32c").tpudfs_crc32c_chunks(
            w, words.shape[0], wc, (inv ^ 0xFFFFFFFF) & 0xFFFFFFFF,
            out.data_ptr(), stream)
    kernels.check("crc32c", rc)
    crc32c_chunks_device.launches += 1
    return out.view(torch.uint32)


#: Kernel launches (CUDA path only) since the last reset.
crc32c_chunks_device.launches = 0


def crc32c_chunks_torch(data, device: torch.device | str | None = None
                        ) -> np.ndarray:
    """Host convenience: bytes -> per-512B-chunk CRCs via the device path
    (the padded layout of :func:`bytes_to_words`)."""
    words = host_to_device(bytes_to_words(data), resolve_device(device))
    return u32_to_numpy(crc32c_chunks_device(words))


# ------------------------------------------------------ whole-block CRC

#: Advance operators the fused kernel may need past M^31: M^(32 * 2^q) for
#: q < 27 reaches blocks of 2^32 chunks.
_ADVANCE_OPS = 27


@lru_cache(maxsize=1)
def fold_ops() -> np.ndarray:
    """(59, 32) uint32: the columns of the operators the fused kernel
    composes, M = advance across one 512-byte chunk of zeros. Row k < 32
    holds M^k, row 32 + q holds M^(32 * 2^q). Row d < 32 equals row n-1-d
    of ``combine_fold_table(512, n)``, which the kernel reads instead when
    it is given a fold table."""
    m = _zero_operator(CHECKSUM_CHUNK_SIZE)
    rows = [tuple(1 << b for b in range(32))]
    for _ in range(32):
        rows.append(tuple(_gf2_matrix_times(m, c) for c in rows[-1]))
    for _ in range(_ADVANCE_OPS - 1):
        rows.append(tuple(_gf2_matrix_square(rows[-1])))
    out = np.array(rows, dtype=np.uint32)
    out.setflags(write=False)
    return out


def fold_table_device(cpb: int, device: torch.device) -> torch.Tensor:
    """The (cpb, 32) combine-fold table on ``device`` (uploaded once); the
    plain twin's fold."""
    return device_constant(("combine_fold_table", cpb), device,
                           lambda: combine_fold_table(CHECKSUM_CHUNK_SIZE, cpb))


def _fold(crcs: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    """(B, cpb) int64 chunk CRCs + (cpb, 32) uint32 table -> (B,) int64
    whole-block CRCs: XOR of D[i, b] over every set bit b of chunk i."""
    shifts = torch.arange(32, device=crcs.device)
    bits = ((crcs[..., None] >> shifts) & 1).bool()
    contrib = torch.where(bits, u32_to_i64(fold)[None], 0)
    return xor_reduce(contrib.reshape(crcs.shape[0], -1))


def crc32c_blocks_plain(words: torch.Tensor, nblocks: int,
                        wcontrib: torch.Tensor, inv: int,
                        fold: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the fused kernel: the plain chunk CRCs, then
    the fold with the (cpb, 32) table -> (nblocks,) uint32."""
    crcs = u32_to_i64(crc32c_chunks_plain(words, wcontrib, inv))
    return i64_to_u32(_fold(crcs.reshape(nblocks, -1), fold))


def crc32c_blocks_device(words: torch.Tensor, nblocks: int, *,
                         wcontrib: torch.Tensor | None = None,
                         inv: int | torch.Tensor | None = None,
                         fold: torch.Tensor | None = None) -> torch.Tensor:
    """Whole-block CRC32C of ``nblocks`` equal-chunk-count blocks laid out
    contiguously in one (nblocks*cpb, 128) uint32 tensor -> (nblocks,)
    uint32, computed over the zero-padded chunk stream. CUDA: one launch of
    the fused kernel, no per-chunk CRC in device memory and no fold after
    it; CPU: :func:`crc32c_blocks_plain`. ``fold`` (the (cpb, 32)
    combine-fold table) overrides the port's operators, ``wcontrib`` /
    ``inv`` its chunk tables."""
    _check_words(words)
    total = words.shape[0]
    if nblocks < 0 or (total and (nblocks == 0 or total % nblocks)):
        raise ValueError(f"{total} chunks do not split into {nblocks} blocks")
    if total == 0:  # crc32c(b"") == 0
        return i64_to_u32(torch.zeros(nblocks, dtype=torch.int64,
                                      device=words.device))
    cpb = total // nblocks
    if fold is not None and tuple(fold.shape) != (cpb, 32):
        raise ValueError(f"fold must be ({cpb}, 32), got {tuple(fold.shape)}")
    wcontrib, inv = _tables(words.device, wcontrib, inv)
    if words.device.type == "cpu":
        if fold is None:
            fold = fold_table_device(cpb, words.device)
        return crc32c_blocks_plain(words, nblocks, wcontrib, inv, fold)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    from tpudfs_torch.gpu import kernels

    from_fold = fold is not None
    ops = fold if from_fold else device_constant("crc32c_fold_ops",
                                                 words.device, fold_ops)
    out = torch.empty(nblocks, dtype=torch.int32, device=words.device)
    w, wc, op, stream = _cuda_args(words, wcontrib, ops)
    with torch.cuda.device(words.device):
        rc = kernels.lib("crc32c").tpudfs_crc32c_blocks(
            w, nblocks, cpb, wc, (inv ^ 0xFFFFFFFF) & 0xFFFFFFFF, op,
            int(from_fold), out.data_ptr(), stream)
    kernels.check("crc32c", rc)
    crc32c_blocks_device.launches += 1
    return out.view(torch.uint32)


#: Kernel launches (CUDA path only) since the last reset.
crc32c_blocks_device.launches = 0


def block_crc_device(words: torch.Tensor, *,
                     wcontrib: torch.Tensor | None = None,
                     inv: int | torch.Tensor | None = None,
                     fold: torch.Tensor | None = None) -> torch.Tensor:
    """Whole-(padded-)block CRC32C on the words' device: a 0-d uint32
    tensor, with no host readback. Computed over the zero-padded chunk
    stream; equals the stored whole-block CRC only when the block length is
    a chunk multiple."""
    return crc32c_blocks_device(words, 1, wcontrib=wcontrib, inv=inv,
                                fold=fold).reshape(())


def batch_block_crc_device(words: torch.Tensor, nblocks: int, *,
                           fold: torch.Tensor | None = None) -> torch.Tensor:
    """Whole-block CRC32C of ``nblocks`` equal-chunk-count blocks laid out
    contiguously in one (nblocks*cpb, 128) tensor -> (nblocks,) uint32
    (:func:`crc32c_blocks_device`)."""
    return crc32c_blocks_device(words, nblocks, fold=fold)


def verify_block_device(words: torch.Tensor,
                        expected: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: True iff every chunk CRC matches ``expected``
    (uint32, computed over the same padded layout)."""
    actual = crc32c_chunks_device(words)
    return (u32_to_i64(actual) == u32_to_i64(expected)).all()

