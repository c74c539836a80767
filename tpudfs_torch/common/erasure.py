"""Reed-Solomon over GF(2^8) — the port's own copy of
``tpudfs/common/erasure.py`` (tables, matrix inverse, generator, encode,
and the host decode of a block from any k shards).

Construction: Vandermonde ``V[r][c] = r**c`` over GF(2^8) (poly 0x11D), made
systematic by multiplying with the inverse of its top k x k block, so the
first k shards are the data and any k rows stay independent. The matrix
product over shard bytes runs the native host engine
(``native/gf256.cc`` through ``common.native``, which raises when it
cannot be built), as the reference does whenever its library is built;
the numpy mul-table gather stays as its plain twin
:func:`_gf_matmul_plain`. The device twin is the bit-plane kernel in
``tpudfs_torch/gpu/rs_cuda.py``, which is held bit-exact with
:func:`encode`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_POLY = 0x11D


class ErasureError(ValueError):
    pass


@lru_cache(maxsize=1)
def _tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(exp, log, mul) tables. mul[a, b] = a*b in GF(2^8)."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[:255]
    a = np.arange(256)
    la, lb = np.meshgrid(log[a], log[a], indexing="ij")
    mul = exp[(la + lb) % 255].astype(np.uint8)
    mul[0, :] = 0
    mul[:, 0] = 0
    return exp, log, mul


def gf_mul(a: int, b: int) -> int:
    return int(_tables()[2][a, b])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    exp, log, _ = _tables()
    return int(exp[(int(log[a]) * n) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    exp, log, _ = _tables()
    return int(exp[(255 - int(log[a])) % 255])


def _matrix_invert(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8). m is (n, n) uint8."""
    _, _, mul = _tables()
    n = m.shape[0]
    aug = np.concatenate([m.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = next((r for r in range(col, n) if aug[r, col]), None)
        if pivot is None:
            raise ErasureError("singular matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv = gf_inv(int(aug[col, col]))
        aug[col] = mul[inv, aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= mul[int(aug[r, col]), aug[col]]
    return aug[:, n:]


def _gf_matmul(mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """out[r] = xor_c mat[r, c] * shards[c], one native call."""
    from tpudfs_torch.common import native

    return native.gf256_matmul(mat, shards)


def _gf_matmul_plain(mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """Plain numpy twin of :func:`_gf_matmul` (mul-table gather)."""
    _, _, mul = _tables()
    rows, cols = mat.shape
    out = np.zeros((rows, shards.shape[1]), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            coef = int(mat[r, c])
            if coef:
                out[r] ^= mul[coef, shards[c]]
    return out


@lru_cache(maxsize=32)
def encode_matrix(k: int, m: int) -> np.ndarray:
    """Systematic (k+m) x k generator matrix; top k rows are identity."""
    if k <= 0 or m <= 0:
        raise ErasureError("data_shards and parity_shards must both be > 0")
    if k + m > 256:
        raise ErasureError("k + m must be <= 256 for GF(2^8)")
    vand = np.zeros((k + m, k), dtype=np.uint8)
    for r in range(k + m):
        for c in range(k):
            vand[r, c] = gf_pow(r, c)
    top_inv = _matrix_invert(vand[:k])
    _, _, mul = _tables()
    out = np.zeros((k + m, k), dtype=np.uint8)
    for r in range(k + m):
        for c in range(k):
            acc = 0
            for i in range(k):
                acc ^= int(mul[vand[r, i], top_inv[i, c]])
            out[r, c] = acc
    return out


def shard_len(data_len: int, data_shards: int) -> int:
    """Bytes per shard: ``ceil(data_len / data_shards)``."""
    if data_shards <= 0:
        raise ErasureError("data_shards must be > 0")
    return -(-data_len // data_shards)


def encode(data, data_shards: int, parity_shards: int) -> list[bytes]:
    """Split ``data`` into k data shards (zero-padded) + m parity shards."""
    if not len(data):
        raise ErasureError("data must not be empty")
    k, m = data_shards, parity_shards
    size = shard_len(len(data), k)
    padded = np.zeros(k * size, dtype=np.uint8)
    padded[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    shards = padded.reshape(k, size)
    parity = _gf_matmul(encode_matrix(k, m)[k:], shards)
    return [shards[i].tobytes() for i in range(k)] + [
        parity[i].tobytes() for i in range(m)
    ]


def decode(shards: list, data_shards: int, parity_shards: int,
           original_len: int) -> bytes:
    """The original data (truncated to ``original_len``) from the ``k + m``
    shard slots, ``None`` for a missing shard: the data shards themselves
    when all are present, else the inverse of the generator's rows of the
    first k survivors applied to them."""
    k, m = data_shards, parity_shards
    if len(shards) != k + m:
        raise ErasureError(f"expected {k + m} shard slots, got {len(shards)}")
    if all(s is not None for s in shards[:k]):
        return b"".join(shards[:k])[:original_len]
    present = [i for i, s in enumerate(shards) if s is not None][:k]
    if len(present) < k:
        raise ErasureError(f"need at least {k} shards, have {len(present)}")
    if len({len(shards[i]) for i in present}) != 1:
        raise ErasureError("present shards have differing lengths")
    avail = np.stack([np.frombuffer(shards[i], dtype=np.uint8)
                      for i in present])
    data = _gf_matmul(_matrix_invert(encode_matrix(k, m)[present]), avail)
    return data.tobytes()[:original_len]
