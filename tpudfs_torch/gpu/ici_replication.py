"""Chain replication and RS(k,m) shard scatter/gather over a ring of device
positions — port of ``tpudfs/tpu/ici_replication.py``.

The reference expresses the write side of the device data plane as
``shard_map`` programs over a JAX mesh: each chain hop is a ``ppermute``
ring shift, every received replica is CRC-verified on the device, and the
ack count is a ``psum``. Here the mesh is a plain :class:`Mesh` of
``torch.device`` positions, a "sharded array" is a Python list of
per-position tensors in flat (row-major) position order, each on its
position's device, and the program is written out per position:

- a ring hop is a ``copy_`` from the sending position's tensor into a
  buffer allocated on the receiving position's device. Between cards it is
  a peer copy (PyTorch orders it after both cards' pending work); on one
  device it is a device copy. It is never ``.to(device)``, which returns
  the SAME storage when the tensor already lies there: a replica would then
  alias its source where ``ppermute`` gives a new buffer;
- the verify is one ``crc32c_chunks_device`` launch per position over every
  chunk the position holds;
- ``psum`` is the sum of the per-position ok bits, left as a 0-d tensor on
  position 0's device (the caller syncs it once).

Positions may share a device: the CPU tests run N positions on
``torch.device("cpu")``, and one card can hold a 3- or 9-position ring.
Multi-host meshes work as in the reference: the ring rides the LAST mesh
axis, the leading axes carry independent write groups, and ``acks`` counts
every position of the whole mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE
from tpudfs_torch.gpu import resolve_device
from tpudfs_torch.gpu.crc32c_cuda import WORDS_PER_CHUNK, crc32c_chunks_device
from tpudfs_torch.gpu.rs_cuda import (
    decode_matrix,
    gf_matmul_words,
    matrix_bits_device,
    pad_shard_len,
    rs_encode_device,
)


class Mesh:
    """Device positions on named axes: ``devices`` is an object ndarray of
    ``torch.device`` (one per position; a device may repeat), ``shape`` maps
    each axis name to its size. Flat position ``p`` is
    ``devices.reshape(-1)[p]``."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"{arr.shape} devices do not fit axes {axis_names}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [resolve_device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))

    def positions(self) -> list[torch.device]:
        """The device of every flat position, in order."""
        return list(self.devices.reshape(-1))


def make_mesh(devices=None, axis: str = "hosts") -> Mesh:
    """A 1-D mesh over ``devices`` (default: every CUDA card; raises without
    one, as ``resolve_device`` does)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(list(devices), (axis,))


def _ring_axis(mesh: Mesh, axis: str | None) -> str:
    """The axis the chain/scatter rings ride. On N-D meshes it must be the
    LAST axis: per-position state built on the host (the gather's decode
    matrices) maps flat position to ring position as ``p % ring_size``,
    which only holds for the last axis."""
    axis = axis or mesh.axis_names[-1]
    if axis != mesh.axis_names[-1]:
        raise ValueError(
            f"ring axis {axis!r} must be the last mesh axis "
            f"{mesh.axis_names[-1]!r}")
    return axis


def _peer(p: int, n: int, shift: int) -> int:
    """Flat position ``shift`` steps around ``p``'s ring row of size n."""
    row = (p // n) * n
    return row + ((p % n) + shift) % n


def _i32(t: torch.Tensor) -> torch.Tensor:
    """A uint32 tensor as int32, the same bits: torch copies int32, not
    uint32, on every device."""
    return t.view(torch.int32)


def _check_sharded(parts: list[torch.Tensor], devs: list[torch.device],
                   what: str, tail: tuple) -> None:
    if len(parts) != len(devs):
        raise ValueError(f"{what}: {len(parts)} tensors for {len(devs)} "
                         "positions")
    shape = tuple(parts[0].shape)
    for p, (t, d) in enumerate(zip(parts, devs)):
        if t.device != d or t.dtype != torch.uint32 or tuple(t.shape) != shape \
                or shape[1:] != tail:
            raise ValueError(
                f"{what}[{p}]: {tuple(t.shape)} {t.dtype} on {t.device}; "
                f"expected uint32 {shape[:1] + tail} on {d}")


def _verify(words: torch.Tensor, expected: torch.Tensor) -> torch.Tensor:
    """0-d bool: every chunk of ``words`` ((C, 128) int32) has its CRC in
    ``expected`` ((C,) int32). One CRC launch."""
    actual = crc32c_chunks_device(words.view(torch.uint32))
    return (_i32(actual) == expected).all()


def _acks(ok: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The reference's ``psum`` of the ok bits over every position: a 0-d
    int32 tensor on ``device``."""
    return torch.stack([o.to(device) for o in ok]).sum().to(torch.int32)


class IciReplicator:
    """R-way chain replication of per-position chunk groups over the mesh."""

    def __init__(self, mesh: Mesh, replication: int = 3,
                 axis: str | None = None):
        self.mesh = mesh
        self.axis = _ring_axis(mesh, axis)
        self.replication = replication
        n = mesh.shape[self.axis]
        # Single-position exception: every hop lands on the sender itself,
        # replicas coincide — degenerate but it runs the whole step. Any
        # MULTI-position mesh must hold R distinct replicas along the ring
        # (a size-1 ring axis on a larger mesh would silently give zero
        # redundancy), so the exception keys on the TOTAL position count.
        if mesh.devices.size > 1 and replication > n:
            raise ValueError(f"replication {replication} > ring axis size {n}")

    def replicate(self, words: list[torch.Tensor], crcs: list[torch.Tensor]):
        """words: per position (C, 128) uint32, its pending chunk batch;
        crcs: per position (C,) uint32, the expected chunk CRCs. Returns
        (replicas, ok, acks): replicas per position (R, C, 128) uint32,
        where group r holds the chunks of ring position p - r; ok per
        position a (1,) bool, its verify bit; acks a 0-d int32 tensor on
        position 0's device, the number of positions (over the whole mesh)
        whose replicas all verified."""
        devs = self.mesh.positions()
        _check_sharded(words, devs, "words", (WORDS_PER_CHUNK,))
        C = words[0].shape[0]
        _check_sharded(crcs, devs, "crcs", ())
        if crcs[0].shape[0] != C:
            raise ValueError(f"{crcs[0].shape[0]} CRCs for {C} chunks")
        n, R = self.mesh.shape[self.axis], self.replication
        replicas = [torch.empty((R, C, WORDS_PER_CHUNK), dtype=torch.int32,
                                device=d) for d in devs]
        expected = [torch.empty((R, C), dtype=torch.int32, device=d)
                    for d in devs]
        for p in range(len(devs)):
            replicas[p][0].copy_(_i32(words[p]))
            expected[p][0].copy_(_i32(crcs[p]))
        for r in range(1, R):
            # Chain hop: every position forwards what it received last to
            # its right neighbour, which lands it in its own buffer.
            for p in range(len(devs)):
                src = _peer(p, n, -1)
                replicas[p][r].copy_(replicas[src][r - 1], non_blocking=True)
                expected[p][r].copy_(expected[src][r - 1], non_blocking=True)
        ok = [_verify(replicas[p].view(R * C, WORDS_PER_CHUNK),
                      expected[p].view(-1)) for p in range(len(devs))]
        return ([t.view(torch.uint32) for t in replicas],
                [o.reshape(1) for o in ok], _acks(ok, devs[0]))


def _parity_of_words(words: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """(C, 128) uint32 words -> (m, shard) uint8 RS(k,m) parity. Shards are
    zero-padded to a 128-byte multiple (``pad_shard_len``), as the
    reference's ``_parity_of_words`` pads them; the scatter pads to whole
    512-byte chunks instead."""
    total = words.shape[0] * CHECKSUM_CHUNK_SIZE
    shard = pad_shard_len(-(-total // k))
    data = torch.zeros((k, shard), dtype=torch.uint8, device=words.device)
    data.view(-1)[:total].copy_(_i32(words).view(torch.uint8).reshape(-1))
    return rs_encode_device(data, k, m)


class EcShardScatter:
    """RS(k,m) shard distribution over the ring — the device twin of the
    storage tier's CONVERT_TO_EC migration.

    Each position RS-encodes its chunk batch into k+m shards on its device
    (the GF(2^8) kernel), computes the per-chunk CRCs of all of them (one
    CRC launch), and shard j rides a ring shift of offset j: position d ends
    up holding shard j of position (d - j) mod n at row j. Every received
    shard is CRC-verified against the sender's CRCs, which travel the same
    ring (one CRC launch a position), and the ok bits are summed."""

    def __init__(self, mesh: Mesh, k: int, m: int, axis: str | None = None):
        self.axis = _ring_axis(mesh, axis)
        n = mesh.shape[self.axis]
        # Degenerate-layout exception only for a single position — see
        # IciReplicator.__init__.
        if mesh.devices.size > 1 and k + m > n:
            raise ValueError(f"RS({k},{m}) scatter needs {k + m} ring "
                             f"positions, axis has {n}")
        self.mesh = mesh
        self.k, self.m = k, m

    def scatter(self, words: list[torch.Tensor]):
        """words: per position (C, 128) uint32. Returns (shards, ok, acks):
        shards per position (k+m, C', 128) uint32, C' = the chunks of one
        shard (padded to whole 512-byte chunks); ok and acks as
        :meth:`IciReplicator.replicate` returns them."""
        devs = self.mesh.positions()
        _check_sharded(words, devs, "words", (WORDS_PER_CHUNK,))
        k, m, n = self.k, self.m, self.mesh.shape[self.axis]
        total = words[0].shape[0] * CHECKSUM_CHUNK_SIZE
        per = -(-total // k)  # ceil bytes per data shard
        shard = -(-per // CHECKSUM_CHUNK_SIZE) * CHECKSUM_CHUNK_SIZE
        S = shard // CHECKSUM_CHUNK_SIZE
        sent, sent_crcs = [], []
        for w, d in zip(words, devs):
            shards = torch.zeros((k + m, shard), dtype=torch.uint8, device=d)
            shards[:k].view(-1)[:total].copy_(
                _i32(w).view(torch.uint8).reshape(-1))
            shards[k:].copy_(rs_encode_device(shards[:k], k, m))
            swords = shards.view(torch.int32).view(k + m, S, WORDS_PER_CHUNK)
            sent.append(swords)
            # The sender's per-chunk CRCs of every shard, in one launch.
            sent_crcs.append(_i32(crc32c_chunks_device(
                swords.view(-1, WORDS_PER_CHUNK).view(torch.uint32)))
                .view(k + m, S))
        received, ok = [], []
        for p, d in enumerate(devs):
            rows = torch.empty((k + m, S, WORDS_PER_CHUNK), dtype=torch.int32,
                               device=d)
            crcs = torch.empty((k + m, S), dtype=torch.int32, device=d)
            for j in range(k + m):
                src = _peer(p, n, -j)
                rows[j].copy_(sent[src][j], non_blocking=True)
                crcs[j].copy_(sent_crcs[src][j], non_blocking=True)
            received.append(rows)
            ok.append(_verify(rows.view(-1, WORDS_PER_CHUNK), crcs.view(-1)))
        return ([t.view(torch.uint32) for t in received],
                [o.reshape(1) for o in ok], _acks(ok, devs[0]))


def decode_select_matrices(k: int, m: int, ring: int, total: int,
                           failed: int | None) -> np.ndarray:
    """(total, k, k+m) uint8: per flat position, its codeword's decode
    inverse composed with the one-hot survivor selection. Column j gets the
    inverse's column for the present-rank of shard j; the excluded shard's
    column stays zero, so garbage from the failed position is ignored by
    the GF product itself. ``failed`` names a ring position (that position
    in EVERY row loses its shards); position p's shard j sits on ring
    position (p + j) mod ring, so the lost index differs per position."""
    mats = np.zeros((total, k, k + m), dtype=np.uint8)
    for idx in range(total):
        i = idx % ring
        j0 = (failed - i) % ring if failed is not None else None
        present = [j for j in range(k + m) if j != j0][:k]
        dec = decode_matrix(k, m, tuple(present))
        for rank, j in enumerate(present):
            mats[idx, :, j] = dec[:, rank]
    mats.setflags(write=False)
    return mats


class EcShardGather:
    """Degraded read on the ring — the inverse of :class:`EcShardScatter`:
    each position gathers its codeword's k+m shards back (row j of
    position s goes to s - j) and RS-decodes around a FAILED position on
    its device.

    The decode matrix differs per position (see
    :func:`decode_select_matrices`); each is built on the host once per
    failure pattern and applied as runtime bit-planes by the GF(2^8) kernel
    (``gf_matmul_words``; the plain twin on the CPU), over all k+m rows,
    zero columns included."""

    def __init__(self, mesh: Mesh, k: int, m: int, axis: str | None = None):
        self.axis = _ring_axis(mesh, axis)
        n = mesh.shape[self.axis]
        if mesh.devices.size > 1 and k + m > n:
            # Same guard as the scatter: on a smaller ring one position
            # holds SEVERAL shards of one codeword, so one failure exceeds
            # what excluding one shard index can repair.
            raise ValueError(f"RS({k},{m}) gather needs {k + m} ring "
                             f"positions, axis has {n}")
        self.mesh = mesh
        self.k, self.m = k, m
        #: failed index -> (total, k, k+m) host matrices.
        self._mats: dict[int | None, np.ndarray] = {}

    def _matrices(self, failed: int | None) -> np.ndarray:
        cached = self._mats.get(failed)
        if cached is None:
            cached = decode_select_matrices(
                self.k, self.m, self.mesh.shape[self.axis],
                self.mesh.devices.size, failed)
            self._mats[failed] = cached
        return cached

    def gather(self, shards: list[torch.Tensor], failed: int | None = None,
               *, matrices=None) -> list[torch.Tensor]:
        """``shards``: the scatter's per-position (k+m, S, 128) layout.
        Returns per position its k reconstructed DATA shards, (k, S, 128)
        uint32, bit-exact with its original encoding even when ring position
        ``failed``'s rows are garbage in every row of the mesh.
        ``matrices`` overrides the (total, k, k+m) uint8 decode matrices
        (see ``gpu.state``)."""
        if failed is not None and self.mesh.devices.size == 1:
            # One position holds EVERY shard of the codeword: excluding one
            # shard index decodes from rows the caller declared garbage.
            raise ValueError(
                "failed=<index> is meaningless on a 1-position mesh: the "
                "single position holds every shard of the codeword")
        devs = self.mesh.positions()
        k, m, n = self.k, self.m, self.mesh.shape[self.axis]
        _check_sharded(shards, devs, "shards", tuple(shards[0].shape[1:]))
        if shards[0].shape[0] != k + m or shards[0].shape[2] != WORDS_PER_CHUNK:
            raise ValueError(f"shards must be (k+m, S, 128), got "
                             f"{tuple(shards[0].shape)}")
        if matrices is None:
            mats = self._matrices(failed)
        else:
            if isinstance(matrices, torch.Tensor):
                matrices = matrices.cpu().numpy()
            mats = np.asarray(matrices, dtype=np.uint8)
            if mats.shape != (len(devs), k, k + m):
                raise ValueError(f"matrices {mats.shape}, expected "
                                 f"{(len(devs), k, k + m)}")
        S = shards[0].shape[1]
        out = []
        for p, d in enumerate(devs):
            rows = torch.empty((k + m, S * WORDS_PER_CHUNK), dtype=torch.int32,
                               device=d)
            for j in range(k + m):
                rows[j].copy_(_i32(shards[_peer(p, n, j)][j]).view(-1),
                              non_blocking=True)
            data = gf_matmul_words(rows.view(torch.uint32),
                                   matrix_bits_device(mats[p], d))
            out.append(data.view(k, S, WORDS_PER_CHUNK))
        return out


def replicated_write_step(mesh: Mesh, replication: int = 3,
                          ec: tuple[int, int] | None = None):
    """The whole write step of the device data plane: chain-replicate each
    position's chunk batch, verify every received replica on its device,
    optionally RS-encode each position's parity shards, and sum the ack
    bits — one pipeline-replicated WriteBlock round."""
    replicator = IciReplicator(mesh, replication)

    def step(words: list[torch.Tensor], crcs: list[torch.Tensor]) -> dict:
        replicas, ok, acks = replicator.replicate(words, crcs)
        out = {"replicas": replicas, "ok": ok, "acks": acks}
        if ec is not None:
            out["parity"] = [_parity_of_words(w, *ec) for w in words]
        return out

    return step
