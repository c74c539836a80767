"""``DfsInfeed`` over erasure-coded files on the CPU: RS(6,3) blocks placed
rotated over nine colocated stores (shard j of the g-th block on store
(g + j) mod 9), one store lost and one present data shard of one block
flipped. Every file lands byte for byte; the port's EC counters
(``ec.shard_bytes``, ``ec.blocks_assembled``, ``ec.blocks_rebuilt``) and
its ``ec.read_shards`` span count what the layout implies: a block whose
lost shard is a data shard is rebuilt, any other joined from its data
shards, and the flipped block is read again, verified, and rebuilt from
the seven shards left. Then the benchmark's readers of these counters and
spans (``portbench/metrics/*.ec63.py``)."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from portbench import harness, program_trace
from tpudfs_torch.client.local import LocalClient
from tpudfs_torch.common import layout, native, trace
from tpudfs_torch.common.checksum import crc32c
from tpudfs_torch.common.erasure import encode, shard_len
from tpudfs_torch.gpu.hbm_reader import device_array_to_bytes
from tpudfs_torch.gpu.infeed import DfsInfeed

CPU = torch.device("cpu")
K, M = 6, 3
BLOCK = 24 * 512
SIZES = (3 * BLOCK + 1000, 2 * BLOCK, BLOCK - 700, 4 * BLOCK + 5)
COUNTERS = ("ec.shard_bytes", "ec.blocks_assembled", "ec.blocks_rebuilt")


def _lay_out(tmp_path, lost: int):
    """The files, their metadata, each block's lost shard index, the
    stores (``LocalClient``'s argument) and their handles."""
    addrs, stores, handles = layout.stores(tmp_path, K + M)
    rng = np.random.default_rng(lost)
    files, metas, lost_index = {}, {}, {}
    g = 0
    for f, size in enumerate(SIZES):
        path = f"/ec/{f}"
        data = rng.integers(0, 256, size, dtype=np.uint8)
        blocks = []
        for i, off in enumerate(range(0, size, BLOCK)):
            piece = data[off : off + BLOCK]
            bid = f"blk_ec_{f}_{i}"
            locs = [addrs[(g + j) % (K + M)] for j in range(K + M)]
            for j, shard in enumerate(encode(piece, K, M)):
                if (g + j) % (K + M) != lost:
                    shard = np.frombuffer(shard, dtype=np.uint8)
                    handles[locs[j]].write(bid, shard,
                                           native.crc32c_chunks(shard))
            blocks.append(layout.block_meta(bid, len(piece), locs,
                                            crc32c(piece.tobytes()), k=K, m=M))
            lost_index[bid] = (lost - g) % (K + M)
            g += 1
        files[path] = data.tobytes()
        metas[path] = {"path": path, "size": size, "blocks": blocks}
    return files, metas, lost_index, stores, handles


def _flip(handles, block, j: int) -> None:
    """Flip a byte of shard ``j``'s file; its sidecar stays."""
    path = handles[block["locations"][j]].block_path(block["block_id"])
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(raw)


class _Sink:
    def __init__(self):
        self.items = []

    def add(self, *span):
        self.items.append(span)


@pytest.mark.parametrize("flip_in_rebuilt", [True, False])
@pytest.mark.parametrize("lost", [0, 4, 8])
def test_ec_infeed_lands_every_byte_and_counts_the_layout(
        tmp_path, lost, flip_in_rebuilt):
    files, metas, lost_index, stores, handles = _lay_out(tmp_path, lost)
    blocks = [b for meta in metas.values() for b in meta["blocks"]]
    # The flipped block: the first whose lost shard is (is not) a data
    # shard; a present data shard of it.
    flipped = next(b for b in blocks
                   if (lost_index[b["block_id"]] < K) == flip_in_rebuilt)
    j = next(j for j in range(K) if j != lost_index[flipped["block_id"]])
    _flip(handles, flipped, j)

    sink, before_sink = _Sink(), trace._sink
    before = trace.counts()
    trace.install(sink)
    try:
        feed = DfsInfeed(LocalClient(stores, metas), sorted(metas), [CPU],
                         prefetch=2)
        landed = {path: b"".join(device_array_to_bytes(b.array, b.size)
                                 for b in got)
                  for path, got in feed.as_sync_iterator()}
    finally:
        trace.install(before_sink)
    after = trace.counts()
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}

    assert landed == files
    assert feed.reader.rereads == 1
    rebuilt = sum(lost_index[b["block_id"]] < K for b in blocks)
    slen = {b["block_id"]: shard_len(b["size"], K) for b in blocks}
    want = {
        # Six shards a block, parity only in place of a lost or corrupt
        # data shard; the flipped block's six good ones again.
        "ec.shard_bytes": K * (sum(slen.values()) + slen[flipped["block_id"]]),
        # The flipped block, joined from its raw data shards first where
        # no data shard is lost, fails its device check and is rebuilt.
        "ec.blocks_assembled": len(blocks) - rebuilt,
        "ec.blocks_rebuilt": rebuilt + 1,
    }
    assert moved == want
    assert feed.reader.ec_rebuilds == rebuilt + 1
    reads = [s for s in sink.items if s[0] == "ec.read_shards"]
    assert len(reads) == len(blocks) + 1
    assert sum(s[3] for s in reads) == want["ec.shard_bytes"]


# ------------------------------------------- the benchmark's readers of them

class _Ctx:
    """What the EC cell's readers read: the window, its steps' landed
    bytes and the counters' change over it."""

    def __init__(self, counters, landed=(600, 600)):
        self.window = (0.0, 10.0)
        self.counters = counters
        self.steps = [types.SimpleNamespace(nbytes=n) for n in landed]


def _span(name, t0, t1, id_, parent):
    return (name, t0, t1, 0, id_, parent, 1)


#: Block 1 joined (stack, upload: 30 ms); block 2 rebuilt (stack, upload,
#: decode: 60 ms); block 3's spans begin after the window.
EC_SPANS = [
    _span("ec.stack", 1.0, 1.02, 11, 1), _span("ec.upload", 1.02, 1.03, 12, 1),
    _span("ec.stack", 2.0, 2.03, 21, 2), _span("ec.upload", 2.03, 2.05, 22, 2),
    _span("ec.decode", 2.05, 2.06, 23, 2), _span("ec.stack", 11.0, 12.0, 31, 3),
]


def test_ec_readers_arithmetic(monkeypatch):
    before = trace._sink
    try:  # loading the reader installs the benchmark's recorder
        host = harness.load_reader("ec.host_ms_per_block.ec63")
    finally:
        trace.install(before)
    monkeypatch.setattr(program_trace._recorder, "items", EC_SPANS)
    assert host(_Ctx({})) == pytest.approx(45.0)
    counters = {"ec.shard_bytes": 1600, "ec.blocks_assembled": 1,
                "ec.blocks_rebuilt": 3}
    assert harness.load_reader("ec.rebuild_share.ec63")(_Ctx(counters)) == 75.0
    assert harness.load_reader("ec.read_amplification.ec63")(
        _Ctx(counters)) == pytest.approx(1600 / 1200)


@pytest.mark.parametrize("name", ["ec.rebuild_share.ec63",
                                  "ec.read_amplification.ec63"])
def test_ec_counter_readers_read_nothing_without_the_counters(name):
    """A port without the ``ec.*`` counters: the cell reports them as 0."""
    read = harness.load_reader(name)
    assert read(_Ctx(dict.fromkeys(COUNTERS, 0))) is None
