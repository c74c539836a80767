"""Reed-Solomon GF(2^8) matrix products on the GPU — port of
``tpudfs/tpu/rs_pallas.py``.

Multiplication by a constant is linear over GF(2)::

    c * x = XOR_{j<8} [bit j of x] * (c * 2^j)

so each output byte is an XOR of masked constants. Shards travel as
uint32 words of 4 packed bytes; byte order inside a word is irrelevant
because every byte gets the same treatment. The constants ``c * 2^j`` of a
matrix are its *bit-planes*, a ``(rows, cols, 8)`` array.

:func:`gf_matmul_words` is the kernel wrapper: a CUDA tensor goes to the
hand-written kernel ``csrc/gf256.cu`` (the bit-planes are a runtime
argument, so one build serves every encode and decode matrix), a CPU tensor
to the plain PyTorch twin of the reference's ``_parity_rows``.
``gf_matmul_runtime`` is plain PyTorch on either device, as it is plain jnp
in the reference.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tpudfs_torch.common.erasure import _matrix_invert, _tables, encode_matrix
from tpudfs_torch.gpu import (
    device_constant,
    host_to_device,
    i64_to_u32,
    resolve_device,
    u32_to_i64,
)

_LANE = 128
_BYTE_LSB = 0x01010101  # bit 0 of each packed byte
#: Largest bit-plane array the kernel takes (rows * cols * 8 values, 48 KiB
#: of uint32; ``csrc/gf256.cu`` states the same limit). Its nibble tables
#: then take at most 192 KiB of shared memory.
MAX_COEFS = 48 * 1024 // 4


def _matrix_bits(mat: np.ndarray) -> np.ndarray:
    """(rows, cols, 8) uint32: bits[r, c, j] = mat[r, c] * 2^j in GF(2^8)."""
    mul = _tables()[2]
    mat = np.asarray(mat, dtype=np.uint8)
    powers = (1 << np.arange(8)).astype(np.uint8)
    out = mul[mat[:, :, None], powers[None, None, :]].astype(np.uint32)
    out.setflags(write=False)
    return out


@lru_cache(maxsize=16)
def coef_bits(k: int, m: int) -> np.ndarray:
    """Bit-planes of the parity rows G[k:] (the encode matrix), (m, k, 8)."""
    return _matrix_bits(encode_matrix(k, m)[k:])


def pad_shard_len(n: int) -> int:
    return -(-n // _LANE) * _LANE


@lru_cache(maxsize=256)
def decode_matrix(k: int, m: int, present: tuple) -> np.ndarray:
    """(k, k) GF(2^8) matrix mapping the first k PRESENT shards (code-word
    rows ``present[:k]``, in that order) back to the k data shards."""
    rows = list(present)[:k]
    if len(rows) < k:
        raise ValueError(f"need {k} present shards, have {len(rows)}")
    out = _matrix_invert(encode_matrix(k, m)[rows])
    out.setflags(write=False)
    return out


def matrix_bits_device(mat: np.ndarray, device: torch.device) -> torch.Tensor:
    """Bit-planes of a host matrix on ``device`` (uploaded once per matrix)."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    key = ("gf_bits", mat.shape, mat.tobytes())
    return device_constant(key, device, lambda: _matrix_bits(mat))


# --------------------------------------------------------------- kernel 2


def gf_rows_plain(words: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (cols, W) uint32 words and
    (rows, cols, 8) bit-planes -> (rows, W) uint32. Extract bit j of every
    byte, spread each set bit to 0xFF with three shift-OR doublings, AND
    with the constant replicated into all four bytes, XOR into the row."""
    w = u32_to_i64(words)
    rep = u32_to_i64(coefs) * _BYTE_LSB
    rows, cols, _ = coefs.shape
    acc = torch.zeros((rows, w.shape[1]), dtype=torch.int64, device=w.device)
    for c in range(cols):
        for j in range(8):
            bits = (w[c] >> j) & _BYTE_LSB
            mask = bits | (bits << 1)
            mask = mask | (mask << 2)
            mask = mask | (mask << 4)
            acc ^= mask[None, :] & rep[:, c, j, None]
    return i64_to_u32(acc)


def _gf_cuda(words: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    from tpudfs_torch.gpu import kernels

    rows, cols, _ = coefs.shape
    if not words.is_contiguous() or not coefs.is_contiguous():
        raise ValueError("words and coefs must be contiguous")
    if coefs.device != words.device or coefs.dtype != torch.uint32:
        raise ValueError("coefs must be uint32 on the words' device")
    out = torch.empty((rows, words.shape[1]), dtype=torch.int32,
                      device=words.device)
    with torch.cuda.device(words.device):  # the stream's card is current
        rc = kernels.lib("gf256").tpudfs_gf256_matmul(
            words.data_ptr(), words.shape[1], rows, cols, coefs.data_ptr(),
            out.data_ptr(),
            torch.cuda.current_stream(words.device).cuda_stream,
        )
    kernels.check("gf256", rc)
    return out.view(torch.uint32)


def gf_matmul_words(words: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """``out[r] = XOR_c mat[r, c] * words[c]`` over GF(2^8) on uint32-packed
    bytes, with the matrix given by its (rows, cols, 8) bit-planes on the
    words' device. CUDA: the hand-written kernel (raises if it cannot
    launch); CPU: the plain twin."""
    if words.dim() != 2 or words.dtype != torch.uint32:
        raise ValueError(f"expected (cols, W) uint32 words, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if coefs.dim() != 3 or coefs.shape[1] != words.shape[0] \
            or coefs.shape[2] != 8:
        raise ValueError(f"bit-planes {tuple(coefs.shape)} do not match "
                         f"{words.shape[0]} input rows")
    if coefs.numel() > MAX_COEFS:
        raise ValueError(f"matrix too large for the kernel: {coefs.numel()} "
                         f"bit-planes > {MAX_COEFS}")
    if words.device.type == "cpu":
        return gf_rows_plain(words, coefs)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    out = _gf_cuda(words, coefs)
    gf_matmul_words.launches += 1
    return out


#: Kernel launches (CUDA path only) since the last reset.
gf_matmul_words.launches = 0


def _gf_bytes(shards: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """Kernel 2 on uint8 shards: (cols, L) -> (rows, L), L a multiple of 4
    (the words are a view of the bytes, no copy)."""
    if shards.dtype != torch.uint8 or shards.shape[1] % 4:
        raise ValueError("shards must be uint8 with length a multiple of 4")
    words = shards.contiguous().view(torch.uint32)
    return gf_matmul_words(words, coefs).view(torch.uint8)


def gf_matmul_device(mat, shards: torch.Tensor) -> torch.Tensor:
    """``out[r] = xor_c mat[r, c] * shards[c]`` over GF(2^8) on the shards'
    device: (rows, cols) uint8 host matrix, (cols, L) uint8 shards ->
    (rows, L) uint8."""
    return _gf_bytes(shards, matrix_bits_device(mat, shards.device))


def rs_encode_device(data_shards: torch.Tensor, k: int, m: int, *,
                     coefs: torch.Tensor | None = None) -> torch.Tensor:
    """Parity shards for on-device data ((k, L) uint8 -> (m, L) uint8).
    ``coefs`` overrides the encode bit-planes (see ``gpu.state``)."""
    if coefs is None:
        coefs = device_constant(("coef_bits", k, m), data_shards.device,
                                lambda: coef_bits(k, m))
    return _gf_bytes(data_shards, coefs)


def rs_decode_device(avail: torch.Tensor, k: int, m: int, present: tuple, *,
                     coefs: torch.Tensor | None = None) -> torch.Tensor:
    """Reconstruct the k data shards on the device from any k survivors.

    ``avail``: (k, L) uint8 — the shards at code-word indices
    ``present[:k]``, row by row in any order. Returns the (k, L) data shards, bit-exact
    with the host reconstruct. The erasure pattern's inverse is computed on
    the host once (cached) and handed to the kernel as runtime bit-planes;
    ``coefs`` overrides them (see ``gpu.state``)."""
    if coefs is None:
        coefs = matrix_bits_device(decode_matrix(k, m, tuple(present)),
                                   avail.device)
    return _gf_bytes(avail, coefs)


def rs_encode_torch(data, k: int, m: int,
                    device: torch.device | str | None = None) -> list[bytes]:
    """Host convenience mirroring ``erasure.encode``: k+m shard byte strings
    (shard length ceil(len/k), zero padded). Parity is computed over the
    128-aligned device layout and truncated; parity is bytewise
    independent, so the truncation is exact."""
    shard = -(-len(data) // k)
    buf = np.zeros((k, pad_shard_len(shard)), dtype=np.uint8)
    flat = np.frombuffer(data, dtype=np.uint8)
    for i in range(k):
        piece = flat[i * shard : (i + 1) * shard]
        buf[i, : len(piece)] = piece
    parity = rs_encode_device(host_to_device(buf, resolve_device(device)),
                              k, m).cpu().numpy()
    return [buf[i, :shard].tobytes() for i in range(k)] + [
        parity[i, :shard].tobytes() for i in range(m)
    ]


# ------------------------------------------- runtime-matrix GF (plain torch)


def _xtimes(words: torch.Tensor) -> list[torch.Tensor]:
    """[words * 2^j for j in 0..7] over GF(2^8) on int64-held packed bytes:
    xtime(x) = (x << 1) ^ (0x1D if x & 0x80) per byte; (hi >> 7) has only
    byte LSBs set and 0x1D fits a byte, so the product stays in its byte."""
    xs = [words]
    cur = words
    for _ in range(7):
        hi = cur & 0x80808080
        lo = cur & 0x7F7F7F7F
        cur = (lo << 1) ^ ((hi >> 7) * 0x1D)
        xs.append(cur)
    return xs


def gf_matmul_runtime(mat: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """``out[r] = xor_c mat[r, c] * words[c]`` over GF(2^8) with a RUNTIME
    coefficient matrix (a tensor on the words' device): (r, c) uint8 and
    (c, W) uint32-packed bytes -> (r, W) uint32. The x * 2^j ladder of each
    input row is shared across output rows; one program serves every
    matrix."""
    r, c = mat.shape
    if words.shape[0] != c:
        raise ValueError(f"matrix is {r}x{c} but words has {words.shape[0]} rows")
    w = u32_to_i64(words)
    coef = mat.to(torch.int64)
    ladders = [_xtimes(w[ci]) for ci in range(c)]
    rows = []
    for ri in range(r):
        acc = torch.zeros(w.shape[1:], dtype=torch.int64, device=w.device)
        for ci in range(c):
            for j in range(8):
                bit = ((coef[ri, ci] >> j) & 1).bool()
                acc ^= torch.where(bit, ladders[ci][j], 0)
        rows.append(acc)
    return i64_to_u32(torch.stack(rows))
