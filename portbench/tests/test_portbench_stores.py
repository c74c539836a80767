"""The harness's layout is the chunkserver's on-disk format: the port's own
block store reads it verified; replicas share one file until a byte of one
is flipped, which breaks only that replica."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.stores import Stores
from tpudfs_torch.chunkserver.blockstore import BlockCorruptionError, BlockStore
from tpudfs_torch.common.checksum import crc32c
from tpudfs_torch.common.erasure import decode


def test_replicated_layout_reads_verified(tmp_path):
    data = np.random.default_rng(1).integers(0, 256, 200_003, dtype=np.uint8)
    stores = Stores(tmp_path, 3)
    meta = stores.write_replicated("/a/b", data, 65536, 3)
    assert [b["size"] for b in meta["blocks"]] == [65536] * 3 + [3395]
    off = 0
    for i, block in enumerate(meta["blocks"]):
        piece = data[off : off + block["size"]].tobytes()
        off += block["size"]
        assert block["checksum_crc32c"] == crc32c(piece)
        first = stores.path(block["locations"][0], block["block_id"])
        for addr in block["locations"]:
            store = BlockStore(stores.dirs[addr])
            assert store.read_verified(block["block_id"]) == piece
            assert stores.path(addr, block["block_id"]).samefile(first)
        assert block["locations"][0] == stores.addrs[i % 3]


def test_flip_breaks_one_replica(tmp_path):
    data = np.arange(70_000, dtype=np.uint8)
    stores = Stores(tmp_path, 3)
    block = stores.write_replicated("/f", data, 65536, 3)["blocks"][0]
    bid, (a, b, c) = block["block_id"], block["locations"]
    stores.flip(a, bid, 1234)
    with pytest.raises(BlockCorruptionError):
        BlockStore(stores.dirs[a]).read_verified(bid)
    for addr in (b, c):
        assert BlockStore(stores.dirs[addr]).read_verified(bid) == \
            data[:65536].tobytes()


def test_ec_layout_loses_its_shards(tmp_path):
    data = np.random.default_rng(2).integers(0, 256, 100_000, dtype=np.uint8)
    stores = Stores(tmp_path, 5)
    meta = stores.write_ec("/e", data, 65536, 3, 2, lost=(0, 3))
    for block, off in zip(meta["blocks"], (0, 65536)):
        shards = [BlockStore(stores.dirs[a]).read_verified(block["block_id"])
                  if j not in (0, 3) else None
                  for j, a in enumerate(block["locations"])]
        assert not (stores.dirs[stores.addrs[0]] / block["block_id"]).exists()
        assert decode(shards, 3, 2, block["size"]) == \
            data[off : off + block["size"]].tobytes()
