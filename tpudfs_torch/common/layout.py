"""Files laid out in the chunkserver's on-disk format, without a cluster:
block stores under a directory, 3x-replicated blocks with their sidecar
CRCs, and the ``GetFileInfo``-shaped metadata that
:class:`tpudfs_torch.client.local.LocalClient` reads them through.

``chip_smoke.py`` and ``tpudfs_torch.bench`` lay out their datasets with
these helpers, the way the reference's chunkservers would have stored
them (the format is ``tpudfs_torch.chunkserver.blockstore``'s, byte for
byte)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tpudfs_torch.chunkserver.blockstore import BlockStore
from tpudfs_torch.common import native
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c_fold


def block_meta(bid: str, size: int, locations, crc: int, **ec) -> dict:
    """One block's entry of a file's metadata (``ec``: ``k=``, ``m=`` for
    an erasure-coded block)."""
    return {"block_id": bid, "size": size, "locations": list(locations),
            "checksum_crc32c": crc, "ec_data_shards": ec.get("k", 0),
            "ec_parity_shards": ec.get("m", 0),
            "original_size": size if ec else 0}


def stores(workdir: Path, n: int) -> tuple[list, dict, dict]:
    """n chunkserver stores under ``workdir``: (addrs, ``LocalClient``
    stores, open ``BlockStore`` handles)."""
    addrs = [f"cs{i}:7000" for i in range(n)]
    paths = {a: (Path(workdir) / f"cs{i}" / "hot", None)
             for i, a in enumerate(addrs)}
    handles = {a: BlockStore(hot, cold) for a, (hot, cold) in paths.items()}
    return addrs, paths, handles


def write_replicated(handles: dict, addrs: list, path: str, data: np.ndarray,
                     block_size: int, tag: str | None = None) -> dict:
    """``data`` as a file of ``block_size`` blocks at 3x replication on
    the first three stores (block i's first replica on store i % 3), each
    replica with its sidecar CRCs (the native CRC); returns the file's
    GetFileInfo-shaped meta. Block ids are ``blk_<tag>_<i>``, the tag by
    default from the path."""
    tag = tag or path.strip("/").replace("/", "_")
    blocks = []
    for i, off in enumerate(range(0, len(data), block_size)):
        piece = data[off : off + block_size]
        sums = native.crc32c_chunks(piece)
        bid = f"blk_{tag}_{i}"
        locs = [addrs[(i + r) % 3] for r in range(3)]
        for a in locs:
            handles[a].write(bid, piece, sums)
        blocks.append(block_meta(bid, len(piece), locs,
                                 crc32c_fold(sums, len(piece),
                                             CHECKSUM_CHUNK_SIZE)))
    return {"path": path, "size": len(data), "blocks": blocks}
