"""State carried across from the JAX package: the kernels' constant tables.

The device path of both packages runs on a handful of constant tables. The
port builds its own (``common.checksum``, ``common.erasure``), and
:func:`from_reference` takes the reference's, as numpy arrays, and returns
them as the port's tensors on a device, so a caller can check that both
sets are equal and drive the same results. Keys:

==================================  =============  ========================
key                                 host array     consumed by
==================================  =============  ========================
``word_contrib_table``              (32, 128) u32  ``crc32c_chunks_device``
``inv_contrib``                     scalar         ``crc32c_chunks_device``
``combine_fold_table/<cpb>``        (cpb, 32) u32  ``block_crc_device``
``coef_bits/<k>,<m>``               (m, k, 8) u32  ``rs_encode_device``
``decode_matrix/<k>,<m>/<present>`` (k, k, 8) u32  ``rs_decode_device``
``gather_matrices/<k>,<m>/<n>/<f>`` (n, k, k+m) u8 ``EcShardGather.gather``
==================================  =============  ========================

``<present>`` is the comma-joined tuple of present shard indices. The
``decode_matrix`` entry holds the bit-planes of the (k, k) inverse, as the
reference bakes them into its kernel. ``gather_matrices`` holds the
per-position decode-and-select matrices of an n-position ring around failed
ring position ``<f>`` (``none``: no failure), as the reference's
``EcShardGather._matrices`` returns them; it stays uint8.

The other state both packages share is the on-disk block store, whose
format ``tpudfs_torch.chunkserver.blockstore`` keeps byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, combine_fold_table
from tpudfs_torch.gpu import host_to_device
from tpudfs_torch.gpu.crc32c_cuda import inv_contrib, word_contrib_table
from tpudfs_torch.gpu.ici_replication import decode_select_matrices
from tpudfs_torch.gpu.rs_cuda import _matrix_bits, coef_bits, decode_matrix


def _parse(key: str) -> tuple[str, tuple, tuple]:
    """key -> (kind, integer arguments, expected host shape)."""
    kind, _, rest = key.partition("/")
    if kind == "word_contrib_table":
        return kind, (), (32, 128)
    if kind == "inv_contrib":
        return kind, (), ()
    if kind == "combine_fold_table":
        return kind, (int(rest),), (int(rest), 32)
    if kind == "coef_bits":
        k, m = (int(x) for x in rest.split(","))
        return kind, (k, m), (m, k, 8)
    if kind == "decode_matrix":
        km, _, present = rest.partition("/")
        k, m = (int(x) for x in km.split(","))
        return kind, (k, m, tuple(int(x) for x in present.split(","))), (k, k, 8)
    if kind == "gather_matrices":
        km, n, failed = rest.split("/")
        k, m = (int(x) for x in km.split(","))
        n = int(n)
        failed = None if failed == "none" else int(failed)
        return kind, (k, m, n, failed), (n, k, k + m)
    raise KeyError(f"unknown table key {key!r}")


_OWN = {
    "word_contrib_table": word_contrib_table,
    "inv_contrib": lambda: np.uint32(inv_contrib()),
    "combine_fold_table": lambda n: combine_fold_table(CHECKSUM_CHUNK_SIZE, n),
    "coef_bits": coef_bits,
    "decode_matrix": lambda k, m, present: _matrix_bits(
        decode_matrix(k, m, present)),
    "gather_matrices": lambda k, m, n, failed: decode_select_matrices(
        k, m, n, n, failed),
}


def own_arrays(keys) -> dict[str, np.ndarray]:
    """The port's own copies of the tables named by ``keys``."""
    out = {}
    for key in keys:
        kind, args, _ = _parse(key)
        out[key] = _OWN[kind](*args)
    return out


def from_reference(arrays: dict[str, np.ndarray],
                   device: torch.device) -> dict[str, torch.Tensor]:
    """The reference's tables as the port's tensors on ``device``.

    Each array is checked against the shape its key implies and held as
    uint32 (``inv_contrib`` as a 0-d int64 tensor, a value in
    [0, 2**32); ``gather_matrices`` as uint8)."""
    out = {}
    for key, arr in arrays.items():
        arr = np.asarray(arr)
        kind, _, want = _parse(key)
        if arr.shape != want:
            raise ValueError(f"{key}: shape {arr.shape}, expected {want}")
        if key == "inv_contrib":
            out[key] = torch.tensor(int(arr), dtype=torch.int64, device=device)
        elif kind == "gather_matrices":
            out[key] = host_to_device(arr.astype(np.uint8), device)
        else:
            out[key] = host_to_device(arr.astype(np.uint32), device)
    return out


def own_tables(keys, device: torch.device) -> dict[str, torch.Tensor]:
    """The port's own tables for ``keys``, as :func:`from_reference` would
    return them."""
    return from_reference(own_arrays(keys), device)
