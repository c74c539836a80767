"""PyTorch + CUDA port of the tpudfs device data plane.

The JAX package (``tpudfs/tpu``) is the reference; this package mirrors its
layout so every module has a named counterpart:

- ``tpudfs_torch.common``: own copies of the pure-numpy CRC32C and GF(2^8)
  helpers (``tpudfs/common/checksum.py``, ``tpudfs/common/erasure.py``);
- ``tpudfs_torch.chunkserver.blockstore``: the on-disk block + ``.meta``
  sidecar format, byte for byte;
- ``tpudfs_torch.client.local``: the short-circuit (colocated) half of the
  client, which is the interface :class:`HbmReader` duck-types;
- ``tpudfs_torch.gpu``: the two hand-written Hopper kernels (CRC32C chunks,
  GF(2^8) matrix product), their plain PyTorch twins, and the verified
  read into device memory (``hbm_reader``).

The port imports torch and numpy only; it never imports jax or ``tpudfs``.
Entry points default to the CUDA device and raise when there is none,
unless the caller passes ``torch.device("cpu")`` explicitly.
"""

from tpudfs_torch.gpu import resolve_device

__all__ = ["resolve_device"]
