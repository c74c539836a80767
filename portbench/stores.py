"""Colocated chunkserver stores laid out from the benchmark's own bytes, in
the chunkserver's on-disk format (a block file and the ``.meta`` sidecar
that ``tpudfs_torch.chunkserver.blockstore.BlockStore`` encodes), with the
``GetFileInfo``-shaped metadata that ``LocalClient`` reads them through.

Every store lives on one host and one disk, and a healthy read touches only
a block's first replica. So a replicated block is written once, on its
first location, and its other replicas are hard links to that file and its
sidecar: the page cache and the disk hold one copy. A byte is only ever
corrupted in a real copy (:meth:`Stores.flip`).

The files are written without an fsync per block (on the card hosts one
per 64 MiB block made set-up take from 8 to over 100 seconds): the layout
is the fixture of a read, not the write path under test. :meth:`Stores.sync`
makes the whole layout durable at once at the end of set-up, so that no
write-back of it runs in the measured window.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from tpudfs_torch.chunkserver.blockstore import BlockStore
from tpudfs_torch.common import native
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c_fold
from tpudfs_torch.common.erasure import encode


def block_meta(bid: str, size: int, locations, crc: int, k: int = 0,
               m: int = 0) -> dict:
    """One block's entry of a file's metadata, as the master returns it."""
    return {"block_id": bid, "size": size, "locations": list(locations),
            "checksum_crc32c": crc, "ec_data_shards": k,
            "ec_parity_shards": m, "original_size": size if k else 0}


def block_crc(piece: np.ndarray) -> int:
    """The whole-block CRC32C the master records at CompleteFile."""
    return crc32c_fold(native.crc32c_chunks(piece), len(piece),
                       CHECKSUM_CHUNK_SIZE)


class Stores:
    """``n`` chunkserver stores under ``root`` (``cs<i>/hot``)."""

    def __init__(self, root: Path, n: int):
        self.addrs = [f"cs{i}:7000" for i in range(n)]
        self.root = Path(root)
        self.dirs = {a: self.root / f"cs{i}" / "hot"
                     for i, a in enumerate(self.addrs)}
        #: The sidecar's encoder of each store (it makes the directory).
        self.formats = {a: BlockStore(d, chunk_size=CHECKSUM_CHUNK_SIZE)
                        for a, d in self.dirs.items()}
        self.metas: dict[str, dict] = {}

    def local(self) -> dict:
        """The ``stores`` argument of ``LocalClient``."""
        return {a: (str(d), None) for a, d in self.dirs.items()}

    def path(self, addr: str, bid: str) -> Path:
        return self.dirs[addr] / bid

    def _link(self, src: str, dst: str, bid: str) -> None:
        for name in (bid, bid + ".meta"):
            os.link(self.dirs[src] / name, self.dirs[dst] / name)

    def _write(self, addr: str, bid: str, data: np.ndarray) -> int:
        """One block file and its sidecar; returns the block's CRC32C."""
        sums = native.crc32c_chunks(data)
        path = self.path(addr, bid)
        path.write_bytes(memoryview(np.ascontiguousarray(data)))
        path.with_name(bid + ".meta").write_bytes(
            self.formats[addr]._encode_meta(sums))
        return crc32c_fold(sums, len(data), CHECKSUM_CHUNK_SIZE)

    def write_replicated(self, path: str, data: np.ndarray, block_size: int,
                         replicas: int, *, write: bool = True) -> dict:
        """``data`` as a file of ``block_size`` blocks, ``replicas`` copies
        each on the first ``replicas`` stores (block i's first copy on store
        i % replicas, the others hard links to it). ``write=False`` records
        the metadata alone: every replica is absent."""
        tag = path.strip("/").replace("/", "_")
        blocks = []
        for i, off in enumerate(range(0, len(data), block_size)):
            piece = data[off : off + block_size]
            bid = f"blk_{tag}_{i}"
            locs = [self.addrs[(i + r) % replicas] for r in range(replicas)]
            if write:
                crc = self._write(locs[0], bid, piece)
                for addr in locs[1:]:
                    self._link(locs[0], addr, bid)
            else:
                crc = block_crc(piece)
            blocks.append(block_meta(bid, len(piece), locs, crc))
        self.metas[path] = {"path": path, "size": len(data), "blocks": blocks}
        return self.metas[path]

    def write_ec(self, path: str, data: np.ndarray, block_size: int, k: int,
                 m: int, lost: tuple = ()) -> dict:
        """``data`` as an RS(k, m) file: shard j of every block on store j,
        the shards in ``lost`` never written."""
        tag = path.strip("/").replace("/", "_")
        blocks = []
        for i, off in enumerate(range(0, len(data), block_size)):
            piece = data[off : off + block_size]
            bid = f"blk_{tag}_{i}"
            for j, shard in enumerate(encode(piece, k, m)):
                if j not in lost:
                    self._write(self.addrs[j], bid,
                                np.frombuffer(shard, dtype=np.uint8))
            blocks.append(block_meta(bid, len(piece), self.addrs[: k + m],
                                     block_crc(piece), k=k, m=m))
        self.metas[path] = {"path": path, "size": len(data), "blocks": blocks}
        return self.metas[path]

    def flip(self, addr: str, bid: str, offset: int) -> None:
        """Replace ``addr``'s copy of block ``bid`` by a real copy of it
        with the byte at ``offset`` flipped; its sidecar stays, so the
        copy no longer matches its CRCs. Other replicas keep the good
        bytes, even where they were hard links to this one."""
        path = self.path(addr, bid)
        data = bytearray(path.read_bytes())
        data[offset] ^= 0xFF
        tmp = path.with_name(path.name + ".flipped")
        tmp.write_bytes(data)
        os.replace(tmp, path)

    def sync(self) -> None:
        """Write every store's files back to the disk, in one ``syncfs``
        of the file system that holds them (``os.sync`` where the C
        library has no ``syncfs``)."""
        syncfs = getattr(ctypes.CDLL(None, use_errno=True), "syncfs", None)
        if syncfs is None:
            os.sync()
            return
        fd = os.open(self.root, os.O_RDONLY)
        try:
            if syncfs(fd) != 0:
                raise OSError(ctypes.get_errno(), "syncfs failed", str(self.root))
        finally:
            os.close(fd)
