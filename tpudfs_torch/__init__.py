"""PyTorch + CUDA port of the tpudfs device data plane.

The JAX package (``tpudfs/tpu``) is the reference; this package mirrors its
layout so every module has a named counterpart:

- ``tpudfs_torch.common``: own copies of the CRC32C, CRC-64 and GF(2^8)
  helpers (``tpudfs/common/checksum.py``, ``tpudfs/common/erasure.py``);
- ``tpudfs_torch.chunkserver.blockstore``: the on-disk block + ``.meta``
  sidecar format, byte for byte;
- ``tpudfs_torch.client.local``: the short-circuit (colocated) half of the
  client, which is the interface :class:`HbmReader` duck-types;
- ``tpudfs_torch.client.client``: the DFS client that speaks to a live
  cluster over the wire (``tpudfs/client/client.py``), over the client
  halves of the RPC substrate, the blockport, write streams, resilience
  scopes and the shard map in ``tpudfs_torch.common``;
- ``tpudfs_torch.cluster``: a launcher that starts the system's master and
  chunkservers as OS processes (``tpudfs/testing/procs.py``);
- ``tpudfs_torch.gpu``: the two hand-written Hopper kernels (CRC32C chunks,
  GF(2^8) matrix product), their plain PyTorch twins, and the verified
  read into device memory (``hbm_reader``);
- ``tpudfs_torch.bench`` with ``read_profile`` and ``sweep_lab``: the
  counterpart of the JAX package's ``bench.py`` and its two read probes.

The port imports torch and numpy (and grpc and msgpack in its client
only); it never imports jax or ``tpudfs``.
Entry points default to the CUDA device and raise when there is none,
unless the caller passes ``torch.device("cpu")`` explicitly.
"""

from tpudfs_torch.gpu import resolve_device

__all__ = ["resolve_device"]
