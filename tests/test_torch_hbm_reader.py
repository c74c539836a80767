"""Port parity for the verified read into device memory:
``tpudfs_torch.gpu.hbm_reader.HbmReader`` on the CPU device against the JAX
reference ``tpudfs.tpu.hbm_reader.HbmReader``, both reading the same files
through the same real ``tpudfs.client.Client`` on an in-process
``MiniCluster``: bytes, ``verified`` flags and lazily confirmed CRCs must
agree exactly. Also the short-circuit ``LocalClient`` over block stores
written by one package and read by the other, and the per-block path's
landing slots (``SlotPool``): reused under few workers and two event
loops without a deadlock or an aliased block, and given back on every
failure path; an erasure-coded block's shards landed in a slot's rows,
parity read only in place of a missing data shard."""

import asyncio
import itertools
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from tests.test_master_service import MiniCluster
from tpudfs.chunkserver.blockstore import BlockCorruptionError as RefBlockCorruptionError
from tpudfs.chunkserver.blockstore import BlockStore as RefBlockStore
from tpudfs.client.client import Client
from tpudfs.client.client import DfsError as RefDfsError
from tpudfs.common.checksum import crc32c
from tpudfs.tpu import hbm_reader as ref
from tpudfs_torch.chunkserver.blockstore import BlockCorruptionError, BlockStore
from tpudfs_torch.client.local import DfsError, LocalClient
from tpudfs_torch.common import layout, native, trace
from tpudfs_torch.common.erasure import decode as ec_decode
from tpudfs_torch.common.erasure import encode as ec_encode
from tpudfs_torch.gpu import hbm_reader as port
from tpudfs_torch.gpu import u32_to_numpy
from tpudfs_torch.gpu.rs_cuda import pad_shard_len

CPU = torch.device("cpu")


def _rand(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _joined(blocks, to_bytes):
    return b"".join(to_bytes(b.array, b.size) for b in blocks)


def _port_bytes(blocks):
    return _joined(blocks, port.device_array_to_bytes)


def _ref_bytes(blocks):
    return _joined(blocks, ref.device_array_to_bytes)


def _moved(before: dict, names) -> dict:
    after = trace.counts()
    return {n: after.get(n, 0) - before.get(n, 0) for n in names}


async def _cluster(tmp_path, files, *, n_cs=3, local_reads=False,
                   block_size=64 * 1024):
    c = MiniCluster(tmp_path, n_masters=1, n_cs=n_cs)
    await c.start()
    leader = await c.leader()
    await c.wait_out_of_safe_mode(leader)
    client = Client(list(c.masters), rpc_client=c.client,
                    block_size=block_size, local_reads=local_reads)
    for path, data, *ec in files:
        await client.create_file(path, data, ec=ec[0] if ec else None)
    return c, client


async def _tamper_everywhere(c, client, path, pos):
    """Rewrite every replica AND its sidecar, so the chunkservers serve the
    bad bytes happily and only the end-to-end device check can trip."""
    meta = await client.get_file_info(path)
    bid = meta["blocks"][-1]["block_id"]
    for cs in c.chunkservers:
        if cs.store.exists(bid):
            raw = bytearray(cs.store.read(bid))
            raw[pos] ^= 0x10
            cs.store.write(bid, bytes(raw))
            cs.invalidate_cached(bid)
    return bid


async def _corrupt_first_replica(c, client, path):
    """Bit-rot the first location's replica in place, sidecar untouched."""
    meta = await client.get_file_info(path)
    block = meta["blocks"][0]
    for cs in c.chunkservers:
        if cs.address == block["locations"][0]:
            p = cs.store.block_path(block["block_id"])
            raw = bytearray(p.read_bytes())
            raw[42] ^= 0xFF
            p.write_bytes(bytes(raw))
            cs.invalidate_cached(block["block_id"])
            return
    raise AssertionError("first replica holder not found")


# ------------------------------------------------ against the JAX reader


async def test_reader_matches_reference_eager_lazy_and_sharded(tmp_path):
    files = [("/t/a", _rand(200_000, seed=5)),           # tail block unaligned
             ("/t/lazy", _rand(4 * 64 * 1024, seed=11)),
             ("/t/sharded", _rand(5 * 64 * 1024 + 4096, seed=7))]
    c, client = await _cluster(tmp_path, files)
    try:
        ours = port.HbmReader(client, [CPU])
        theirs = ref.HbmReader(client, jax.devices()[:1])
        for path, data in files[:2]:
            mine = await ours.read_file_to_device_blocks(path)
            want = await theirs.read_file_to_device_blocks(path)
            assert [b.verified for b in mine] == [b.verified for b in want]
            assert all(b.verified for b in mine)
            assert _port_bytes(mine) == _ref_bytes(want) == data

            mine = await ours.read_file_to_device_blocks(path, verify="lazy")
            want = await theirs.read_file_to_device_blocks(path, verify="lazy")
            mine_pending = [None if b.pending_crc is None
                            else int(u32_to_numpy(b.pending_crc.reshape(1))[0])
                            for b in mine]
            want_pending = [None if b.pending_crc is None
                            else int(np.asarray(b.pending_crc)) for b in want]
            assert mine_pending == want_pending
            await ours.confirm(mine)
            await theirs.confirm(want)
            assert all(b.verified and b.pending_crc is None for b in mine)
            assert [b.verified for b in mine] == [b.verified for b in want]
            assert _port_bytes(mine) == data
            await ours.confirm(mine)  # idempotent
        # Sharded: an ordered per-device list in place of a NamedSharding.
        path, data = files[2]
        ours2 = port.HbmReader(client, [CPU, CPU])
        shards = await ours2.read_file_sharded(path)
        arr = await ref.HbmReader(client, jax.devices()[:2]).read_file_sharded(path)
        got = np.concatenate([u32_to_numpy(s) for s in shards])
        np.testing.assert_array_equal(got, np.asarray(arr))
        assert got.reshape(-1).view(np.uint8)[: len(data)].tobytes() == data
        assert ours.rereads == 0
    finally:
        await c.stop()


async def test_reader_tamper_detection_eager_lazy_and_tail(tmp_path):
    files = [("/t/bad", _rand(4096, seed=6)),
             ("/t/lazybad", _rand(64 * 1024, seed=12)),
             ("/t/tail", _rand(64 * 1024 + 300, seed=13))]
    c, client = await _cluster(tmp_path, files)
    try:
        ours = port.HbmReader(client, [CPU])
        theirs = ref.HbmReader(client, jax.devices()[:1])
        tail = await ours.read_file_to_device_blocks("/t/tail", verify="lazy")
        assert [b.size % 512 for b in tail] == [0, 300]
        assert tail[-1].verified and tail[-1].pending_crc is None

        await _tamper_everywhere(c, client, "/t/bad", 100)
        with pytest.raises(DfsError, match="on-device checksum mismatch"):
            await ours.read_file_to_device_blocks("/t/bad")
        with pytest.raises(RefDfsError, match="on-device checksum mismatch"):
            await theirs.read_file_to_device_blocks("/t/bad")

        bid = await _tamper_everywhere(c, client, "/t/lazybad", 4000)
        blocks = await ours.read_file_to_device_blocks("/t/lazybad", verify="lazy")
        with pytest.raises(DfsError) as ei:
            await ours.confirm(blocks)
        assert bid in str(ei.value)

        # A tail block cannot defer to confirm(): lazy raises at read time.
        await _tamper_everywhere(c, client, "/t/tail", -1)
        with pytest.raises(DfsError):
            await ours.read_file_to_device_blocks("/t/tail", verify="lazy")
        with pytest.raises(RefDfsError):
            await theirs.read_file_to_device_blocks("/t/tail", verify="lazy")
    finally:
        await c.stop()


@pytest.mark.parametrize("local_reads", [False, True])
async def test_reader_retries_corrupt_replica(tmp_path, local_reads):
    files = [("/cl/a", _rand(16 * 512, seed=14)),
             ("/cl/b", _rand(16 * 512, seed=15))]
    c, client = await _cluster(tmp_path, files, local_reads=local_reads)
    try:
        await _corrupt_first_replica(c, client, "/cl/a")
        await _corrupt_first_replica(c, client, "/cl/b")
        reader = port.HbmReader(client, [CPU])
        blocks = await reader.read_file_to_device_blocks("/cl/a", verify=True)
        assert all(b.verified for b in blocks)
        assert _port_bytes(blocks) == files[0][1]
        blocks = await reader.read_file_to_device_blocks("/cl/b", verify="lazy")
        await reader.confirm(blocks)  # the retry path resolves the rot
        assert all(b.verified for b in blocks)
        assert _port_bytes(blocks) == files[1][1]
        # With the short-circuit on, the unverified local pread returns the
        # rot and only the device check catches it: each read re-reads once.
        assert reader.rereads == (2 if local_reads else 0)
    finally:
        await c.stop()


async def test_reader_ec_degraded_reconstructs_on_device(tmp_path):
    """Degraded EC read around two stopped chunkservers through the
    reference client, which returns each shard as bytes: the k survivors
    are copied into the slot's rows, rebuilt by the GF(2^8) twin, and the
    device fold verifies them."""
    data = _rand(192 * 512, seed=12)  # chunk-multiple: device fold path
    c, client = await _cluster(tmp_path, [("/ec/dev", data, (4, 2))], n_cs=6,
                               block_size=1 << 20)
    try:
        meta = await client.get_file_info("/ec/dev")
        block = meta["blocks"][0]
        for cs in list(c.chunkservers):
            if cs.address in block["locations"][:2]:
                await cs.stop()
        ours = port.HbmReader(client, [CPU])
        theirs = ref.HbmReader(client, jax.devices()[:1])
        before = trace.counts()
        mine = await ours.read_file_to_device_blocks("/ec/dev")
        moved = _moved(before, ("ec.rows_landed", "ec.rows_copied"))
        # The reference client returns bytes: each row copied in.
        assert moved == {"ec.rows_landed": 0, "ec.rows_copied": 4}
        want = await theirs.read_file_to_device_blocks("/ec/dev")
        assert len(mine) == 1 and mine[0].verified and want[0].verified
        assert _port_bytes(mine) == _ref_bytes(want) == data
        lazy = await ours.read_file_to_device_blocks("/ec/dev", verify="lazy")
        assert int(u32_to_numpy(lazy[0].pending_crc.reshape(1))[0]) == crc32c(data)
        await ours.confirm(lazy)
        assert lazy[0].verified
    finally:
        await c.stop()


async def test_reader_ec_degraded_detects_corrupt_shard(tmp_path):
    data = _rand(64 * 512, seed=13)
    c, client = await _cluster(tmp_path, [("/ec/bad", data, (4, 2))], n_cs=6,
                               block_size=1 << 20)
    try:
        block = (await client.get_file_info("/ec/bad"))["blocks"][0]
        bid = block["block_id"]
        for cs in list(c.chunkservers):
            if cs.address == block["locations"][0]:
                await cs.stop()
        for cs in list(c.chunkservers):
            if cs.address == block["locations"][1] and cs.store.exists(bid):
                raw = bytearray(cs.store.read(bid))
                raw[10] ^= 0xFF
                cs.store.write(bid, bytes(raw))
                cs.invalidate_cached(bid)
        with pytest.raises(DfsError, match="checksum mismatch"):
            await port.HbmReader(client, [CPU]).read_file_to_device_blocks("/ec/bad")
    finally:
        await c.stop()


@pytest.mark.parametrize("verify,size,rot", [
    ("lazy", 6 * 64 * 1024, False),
    (True, 6 * 64 * 1024, False),
    ("lazy", 6 * 64 * 1024 + 100, False),
    (True, 6 * 64 * 1024 + 100, False),
    ("lazy", 6 * 64 * 1024, True),
    (True, 6 * 64 * 1024, True),
], ids=["lazy", "eager", "tail-lazy", "tail-eager", "rot-lazy", "rot-eager"])
async def test_read_meta_blocks_fast_matches_general_path(tmp_path, verify,
                                                          size, rot):
    """Over cached metadata, ``read_meta_blocks_fast`` gives the general
    path's bytes and verdicts, eager or lazy, an unaligned tail block
    included. A local replica rotted on disk after the metadata was cached
    is caught by the device check and re-read from a healthy replica."""
    data = _rand(size, seed=30)
    c, client = await _cluster(tmp_path, [("/wf/a", data)], local_reads=True)
    try:
        reader = port.HbmReader(client, [CPU])
        meta = await client.get_file_info("/wf/a")
        general = await reader.read_file_to_device_blocks("/wf/a",
                                                          verify=verify)
        await reader.confirm(general)
        if rot:
            await _corrupt_first_replica(c, client, "/wf/a")
        before = reader.rereads
        blocks = await reader.read_meta_blocks_fast(meta, verify=verify)
        # Lazy defers every whole-chunk block's verdict; a tail block and
        # an eager read settle theirs at once.
        assert [b.pending_crc is not None for b in blocks] == [
            verify == "lazy" and b.size % 512 == 0 for b in blocks]
        await reader.confirm(blocks)
        assert all(b.verified for b in blocks)
        assert [b.verified for b in blocks] == [b.verified for b in general]
        assert _port_bytes(blocks) == _port_bytes(general) == data
        if rot:
            assert reader.rereads - before >= 1
        else:
            assert reader.rereads == before == 0
    finally:
        await c.stop()


# ---------------------------------------- block stores across the packages


def _layout(store, blocks):
    for bid, data in blocks.items():
        store.write(bid, data)


def test_block_store_format_is_shared(tmp_path):
    blocks = {"b_aligned": _rand(8 * 512, seed=1), "b_tail": _rand(3000, seed=2),
              "b_empty": b""}
    mine = BlockStore(tmp_path / "port" / "hot")
    theirs = RefBlockStore(tmp_path / "ref" / "hot")
    _layout(mine, blocks)
    _layout(theirs, blocks)
    for bid, data in blocks.items():
        for name in (bid, bid + ".meta"):
            assert (tmp_path / "port" / "hot" / name).read_bytes() == \
                (tmp_path / "ref" / "hot" / name).read_bytes()
        # Each package reads and verifies the other's block and sidecar.
        reader_of_port = RefBlockStore(tmp_path / "port" / "hot")
        reader_of_ref = BlockStore(tmp_path / "ref" / "hot")
        assert reader_of_port.read_verified(bid) == data
        assert bytes(reader_of_ref.read_verified(bid)) == data
        np.testing.assert_array_equal(reader_of_ref.read_meta(bid),
                                      reader_of_port.read_meta(bid))
        if data:
            assert reader_of_ref.read_verified(bid, 100, 700) == data[100:800]


def test_block_store_detects_rot_and_reads_into_sink(tmp_path):
    store = BlockStore(tmp_path / "hot", tmp_path / "cold")
    data = _rand(4096 + 17, seed=3)
    store.write("blk", data)
    sink = store.read("blk", into=lambda n: np.zeros(n + 64, np.uint8)[:n])
    assert sink.tobytes() == data and sink.base.shape == (len(data) + 64,)
    p = store.block_path("blk")
    raw = bytearray(p.read_bytes())
    raw[4100] ^= 1
    p.write_bytes(bytes(raw))
    with pytest.raises(BlockCorruptionError):
        store.read_verified("blk")
    with pytest.raises(RefBlockCorruptionError):
        RefBlockStore(tmp_path / "hot", tmp_path / "cold").read_verified("blk")


async def test_local_client_reads_reference_written_stores(tmp_path):
    """A colocated reader over stores the JAX package's BlockStore wrote:
    replicated (aligned and tail) and degraded EC blocks, one confirm."""
    from tpudfs.common.erasure import encode

    rng = np.random.default_rng(17)
    addrs = [f"cs{i}:1" for i in range(6)]
    ref_stores = {a: RefBlockStore(tmp_path / a / "hot", tmp_path / a / "cold")
                  for a in addrs}
    big = rng.integers(0, 256, 3 * 8192, dtype=np.uint8).tobytes()
    tail = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    metas = {}
    for path, data in (("/r/big", big), ("/r/tail", tail)):
        blocks = []
        for i, off in enumerate(range(0, len(data), 8192)):
            piece = data[off : off + 8192]
            bid = f"{path[3:]}_{i}"
            locs = addrs[i % 3 : i % 3 + 3]
            for a in locs:
                ref_stores[a].write(bid, piece)
            blocks.append({"block_id": bid, "size": len(piece),
                           "locations": locs, "checksum_crc32c": crc32c(piece),
                           "ec_data_shards": 0, "ec_parity_shards": 0,
                           "original_size": 0})
        metas[path] = {"path": path, "size": len(data), "blocks": blocks}
    ecdata = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()
    for i, shard in enumerate(encode(ecdata, 4, 2)):
        if i not in (0, 2):
            ref_stores[addrs[i]].write("ec_0", shard)
    metas["/r/ec"] = {"path": "/r/ec", "size": 8192, "blocks": [{
        "block_id": "ec_0", "size": 8192, "locations": addrs,
        "checksum_crc32c": crc32c(ecdata), "ec_data_shards": 4,
        "ec_parity_shards": 2, "original_size": 8192}]}
    client = LocalClient({a: (tmp_path / a / "hot", tmp_path / a / "cold")
                          for a in addrs}, metas)
    reader = port.HbmReader(client, [CPU])
    got = {}
    every = []
    for path in metas:
        got[path] = await reader.read_file_to_device_blocks(path, verify="lazy")
        every += got[path]
    await reader.confirm(every)
    assert all(b.verified for b in every)
    assert _port_bytes(got["/r/big"]) == big
    assert _port_bytes(got["/r/tail"]) == tail
    assert _port_bytes(got["/r/ec"]) == ecdata
    with pytest.raises(DfsError, match="file not found"):
        await reader.read_file_to_device_blocks("/r/none")


# ------------------------------------------------- the EC block's rows

#: An EC file's blocks: one whose shards are whole rows of the decoder's
#: width (no pad, whole chunks) and a tail whose rows have a pad.
EC_SIZES = (12 * 512, 5 * 512 + 37)
EC_COUNTS = ("ec.rows_landed", "ec.rows_copied", "ec.shard_bytes",
             "ec.blocks_rebuilt", "ec.blocks_assembled")


def _ec_layout(tmp_path, k, m, lost=(), sizes=EC_SIZES, path="/e/a"):
    """An RS(k, m) file of ``sizes`` blocks on k + m local stores, shard j
    of each block on store j, shards ``lost`` never written: the client,
    the stores' handles, the metadata, the file's bytes and each block's
    k + m shards."""
    addrs, paths, handles = layout.stores(tmp_path, k + m)
    data = _rand(sum(sizes), seed=50 + k)
    blocks, shards, off = [], [], 0
    for i, size in enumerate(sizes):
        piece = data[off:off + size]
        off += size
        parts = ec_encode(piece, k, m)
        for j, shard in enumerate(parts):
            if j not in lost:
                handles[addrs[j]].write(f"blk_ec_{i}", shard)
        shards.append(parts)
        blocks.append(layout.block_meta(f"blk_ec_{i}", size, addrs,
                                        crc32c(piece), k=k, m=m))
    metas = {path: {"path": path, "size": len(data), "blocks": blocks}}
    return LocalClient(paths, metas), handles, metas, data, shards


EC_CASES = [(k, m, lost) for k, m in ((3, 2), (6, 3))
            for n in range(m + 1)
            for lost in itertools.combinations(range(k + m), n)]


@pytest.mark.parametrize("verify", [True, "lazy"])
@pytest.mark.parametrize(
    "k,m,lost", EC_CASES,
    ids=[f"rs{k}{m}-lost-{'-'.join(map(str, lost)) or 'none'}"
         for k, m, lost in EC_CASES])
def test_ec_block_lands_in_its_rows(tmp_path, k, m, lost, verify):
    """An RS(k, m) file read with shards ``lost`` gone, data or parity:
    every block lands bit-exact with the host decode and the source, each
    of its k rows read straight from a shard, none copied; k shards are
    read a block, parity only in place of a lost data shard; the block is
    rebuilt on the device where a data shard is lost, else joined."""
    client, _handles, metas, data, shards = _ec_layout(tmp_path, k, m, lost)
    reader = port.HbmReader(client, [CPU])

    async def read():
        blocks = await reader.read_file_to_device_blocks("/e/a",
                                                         verify=verify)
        await reader.confirm(blocks)
        return blocks

    before = trace.counts()
    blocks = asyncio.run(read())
    moved = _moved(before, EC_COUNTS)
    assert all(b.verified for b in blocks)
    for b, parts, size in zip(blocks, shards, EC_SIZES):
        kept = [None if j in lost else s for j, s in enumerate(parts)]
        assert port.device_array_to_bytes(b.array, b.size) == \
            ec_decode(kept, k, m, size)
    assert _port_bytes(blocks) == data
    n = len(EC_SIZES)
    rebuilt = n if any(j < k for j in lost) else 0
    assert moved == {"ec.rows_landed": k * n, "ec.rows_copied": 0,
                     "ec.shard_bytes": k * sum(len(p[0]) for p in shards),
                     "ec.blocks_rebuilt": rebuilt,
                     "ec.blocks_assembled": n - rebuilt}
    assert reader.rereads == 0 and _taken(reader._pools[CPU]) == 0


# ------------------------------------------- the per-block landing slots

SLOT_BLOCK = 8 * 512


def _slot_layout(tmp_path, files):
    """``files`` ((path, size) pairs) of SLOT_BLOCK blocks at 3x on three
    local stores: the client, the stores' handles, the metadata and each
    file's bytes."""
    addrs, paths, handles = layout.stores(tmp_path, 3)
    metas, datas = {}, {}
    for i, (path, size) in enumerate(files):
        data = np.frombuffer(_rand(size, seed=40 + i), dtype=np.uint8)
        metas[path] = layout.write_replicated(handles, addrs, path, data,
                                              SLOT_BLOCK)
        datas[path] = data.tobytes()
    return LocalClient(paths, metas), handles, metas, datas


def _taken(pool) -> int:
    """Bytes of the pool's slots taken and not given back."""
    return pool.held - sum(s.nbytes for free in pool._free.values()
                           for s in free)


@pytest.mark.parametrize("verify", [True, "lazy"])
def test_slots_reused_under_few_workers_without_deadlock(tmp_path,
                                                         monkeypatch, verify):
    """17 blocks in flight at once on a loop with 2 workers and a pool of
    3 slots (a tail block's smaller slot among them): the read completes,
    every block equals its source once all have landed, blocks waited for
    slots, and the pool never held more than its budget."""
    monkeypatch.setattr(port, "SLOT_BUDGET", 3 * SLOT_BLOCK)
    client, _handles, metas, datas = _slot_layout(
        tmp_path, [("/s/a", 10 * SLOT_BLOCK), ("/s/b", 6 * SLOT_BLOCK + 100)])
    reader = port.HbmReader(client, [CPU])
    waits = trace.counts().get("reader.slot_waits", 0)

    async def read_all():
        got = await asyncio.gather(*(
            reader.read_file_to_device_blocks(p, verify=verify)
            for p in metas))
        await reader.confirm([b for blocks in got for b in blocks])
        return got

    loop = asyncio.new_event_loop()
    loop.set_default_executor(ThreadPoolExecutor(2))
    try:
        got = loop.run_until_complete(asyncio.wait_for(read_all(), 60))
    finally:
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()
    for path, blocks in zip(metas, got):
        assert all(b.verified for b in blocks)
        assert _port_bytes(blocks) == datas[path]
    pool = reader._pools[CPU]
    assert trace.counts()["reader.slot_waits"] > waits
    assert 0 < pool.peak <= 3 * SLOT_BLOCK
    assert _taken(pool) == 0


def test_slots_shared_by_two_event_loops(tmp_path, monkeypatch):
    """One reader read from two threads, each running its own loop, through
    a pool of 2 slots: a slot given back on one loop wakes a block waiting
    on the other, and both files land whole."""
    monkeypatch.setattr(port, "SLOT_BUDGET", 2 * SLOT_BLOCK)
    client, _handles, metas, datas = _slot_layout(
        tmp_path, [("/t/a", 6 * SLOT_BLOCK), ("/t/b", 6 * SLOT_BLOCK)])
    reader = port.HbmReader(client, [CPU])
    out = {}

    def run(path):
        out[path] = asyncio.run(asyncio.wait_for(
            reader.read_file_to_device_blocks(path), 60))

    threads = [threading.Thread(target=run, args=(p,)) for p in metas]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    assert not any(t.is_alive() for t in threads)
    for path in metas:
        assert _port_bytes(out[path]) == datas[path]
    pool = reader._pools[CPU]
    assert 0 < pool.peak <= 2 * SLOT_BLOCK
    assert _taken(pool) == 0


def _stalled(read, block_id, started, go, wrote, before_into=False):
    """``read`` (a store's ``read`` or ``read_verified``) whose read of
    ``block_id`` waits for ``go`` after it asks for its buffer (or before,
    ``before_into``) and before it writes there; ``started`` is set as it
    begins to wait, ``wrote`` once that read has ended."""
    def run(bid, offset=0, length=None, *, into=None):
        if bid != block_id or into is None:
            return read(bid, offset, length, into=into)

        def gated(nbytes):
            buf = None if before_into else into(nbytes)
            started.set()
            assert go.wait(10)
            return buf if buf is not None else into(nbytes)

        try:
            return read(bid, offset, length, into=gated)
        finally:
            wrote.set()
    return run


def _ec_fault(tmp_path, fault):
    """An RS(3,2) file of three SLOT_BLOCK blocks whose middle block fails
    in one way; (client, block, data, the slot size of a block)."""
    lost = (0, 1, 3) if fault == "ec_too_few" else (
        (1,) if fault == "ec_missing_data" else ())
    client, handles, metas, data, _shards = _ec_layout(
        tmp_path, 3, 2, sizes=(SLOT_BLOCK,) * 3)
    block = metas["/e/a"]["blocks"][1]
    for j in lost:
        handles[block["locations"][j]].block_path(block["block_id"]).unlink()
    if fault == "ec_corrupt_data":
        p = handles[block["locations"][1]].block_path(block["block_id"])
        raw = bytearray(p.read_bytes())
        raw[42] ^= 0xFF
        p.write_bytes(bytes(raw))
    slen = -(-SLOT_BLOCK // 3)
    return client, block, data, 3 * pad_shard_len(slen)


@pytest.mark.parametrize("fault", ["missing_replica", "corrupt_first_replica",
                                   "short_read", "failed_verify",
                                   "ec_missing_data", "ec_corrupt_data",
                                   "ec_too_few", "ec_cancelled"])
def test_slots_come_back_on_every_failure_path(tmp_path, monkeypatch, fault):
    """The middle block of a file fails in one way: no replica on disk
    (the read fails before it lands), its first replica flipped (caught on
    the device, re-read through the host-verified path), every replica cut
    short, or every replica and sidecar rewritten with one byte flipped
    (only the device check trips). Of an RS(3,2) file: a data shard
    missing (parity takes its row), a data shard flipped (caught on the
    device, re-read through the host-verified path, where it fails its
    sidecar and parity takes its row), three shards missing (too few),
    or the read cancelled while a shard's worker is to write its row (the
    slot is dropped, not pooled). Afterwards no slot is taken, and the
    whole budget can be taken again at once."""
    if fault.startswith("ec_"):
        client, block, data, size = _ec_fault(tmp_path, fault)
        path = "/e/a"
    else:
        size, path = SLOT_BLOCK, "/f/a"
        client, handles, metas, datas = _slot_layout(
            tmp_path, [(path, 3 * SLOT_BLOCK)])
        data = datas[path]
        block = metas[path]["blocks"][1]
        bid = block["block_id"]
        stores = [handles[a] for a in block["locations"]]
    monkeypatch.setattr(port, "SLOT_BUDGET", 2 * size)
    if fault == "missing_replica":
        for store in stores:
            store.block_path(bid).unlink()
    elif fault == "corrupt_first_replica":
        p = stores[0].block_path(bid)
        raw = bytearray(p.read_bytes())
        raw[42] ^= 0xFF
        p.write_bytes(bytes(raw))
    elif fault == "short_read":
        for store in stores:
            p = store.block_path(bid)
            p.write_bytes(p.read_bytes()[:SLOT_BLOCK - 100])
    elif fault == "failed_verify":
        raw = bytearray(data[SLOT_BLOCK:2 * SLOT_BLOCK])
        raw[7] ^= 1
        for store in stores:
            store.write(bid, bytes(raw))
    reader = port.HbmReader(client, [CPU])
    read = reader.read_file_to_device_blocks(path)
    if fault == "ec_cancelled":
        read.close()
        started, go, wrote = (threading.Event() for _ in range(3))
        store, _ = client._local_stores[block["locations"][0]]
        store.read = _stalled(store.read, block["block_id"], started, go,
                              wrote)

        async def cancelled():
            task = asyncio.create_task(
                reader.read_block_to_device(block, CPU))
            assert await asyncio.to_thread(started.wait, 10)
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            pool = reader._pools[CPU]
            dropped = pool.held == 0 and not any(pool._free.values())
            go.set()
            assert await asyncio.to_thread(wrote.wait, 10)
            return dropped

        assert asyncio.run(asyncio.wait_for(cancelled(), 60))
    elif fault in ("corrupt_first_replica", "ec_missing_data",
                   "ec_corrupt_data"):
        assert _port_bytes(asyncio.run(read)) == data
        assert reader.rereads == (0 if fault == "ec_missing_data" else 1)
    else:
        with pytest.raises(DfsError):
            asyncio.run(read)
    pool = reader._pools[CPU]
    assert pool.peak > 0 and _taken(pool) == 0

    async def take_budget():
        return [await asyncio.wait_for(pool.take(size), 5)
                for _ in range(2)]

    assert len(asyncio.run(take_budget())) == 2


def test_ec_slots_stop_growing_over_cold_restores(tmp_path, monkeypatch):
    """The cold restore's layout at a small size, on a budget of three EC
    blocks' slots: each restore first reads a hot copy whose replicas are
    gone (each block takes a slot of its padded size and fails before it
    lands), then the RS(3,2) copy with shards 0 and 3 lost, whose rows take
    a few bytes more a block. The pool's slots settle on the rows' size:
    after the second restore none is allocated, and the pool never holds
    more than its budget."""
    sizes = (SLOT_BLOCK,) * 5 + (1000,)
    client, _handles, metas, data, _shards = _ec_layout(
        tmp_path, 3, 2, (0, 3), sizes=sizes, path="/c/ec")
    client.metas["/c/hot"] = dict(metas["/c/ec"], path="/c/hot", blocks=[
        layout.block_meta(f"gone_{i}", b["size"], ["cs0:7000"],
                          b["checksum_crc32c"])
        for i, b in enumerate(metas["/c/ec"]["blocks"])])
    slen = -(-SLOT_BLOCK // 3)
    rows = 3 * pad_shard_len(slen)
    assert rows > SLOT_BLOCK
    monkeypatch.setattr(port, "SLOT_BUDGET", 3 * rows)
    reader = port.HbmReader(client, [CPU])

    async def restore():
        with pytest.raises(DfsError):
            await reader.read_file_to_device_blocks("/c/hot")
        return await reader.read_file_to_device_blocks("/c/ec")

    allocs = []
    for _ in range(4):
        before = trace.counts().get("reader.slot_allocs", 0)
        assert _port_bytes(asyncio.run(restore())) == data
        allocs.append(trace.counts()["reader.slot_allocs"] - before)
    pool = reader._pools[CPU]
    assert allocs[0] > 0 and allocs[2:] == [0, 0], allocs
    assert 0 < pool.peak <= 3 * rows and _taken(pool) == 0


def test_pinned_slots_count_what_they_pin():
    """On a card a slot holds what PyTorch's caching host allocator pins
    for it, the next power of two: the cold restore's RS(3,2) rows of a
    64 MiB block (3 x 22,369,664 bytes) take a 128 MiB slot, which a hot
    attempt's 64 MiB grid and a tail block then reuse; a block larger than
    the budget gets none. Nothing is pinned here: a slot's buffer comes
    with its first landing."""
    pool = port.SlotPool(pinned=True)
    rows = 3 * 22_369_664

    async def takes():
        ec = await pool.take(rows)
        assert ec.nbytes == 1 << 27 and pool.held == pool.peak == 1 << 27
        pool.give(ec)
        for nbytes in (64 << 20, port.padded_len(10_000_000)):
            slot = await pool.take(nbytes)
            assert slot is ec
            pool.give(slot)
        assert await pool.take(port.SLOT_BUDGET + 1) is None

    before = trace.counts().get("reader.slot_allocs", 0)
    asyncio.run(takes())
    assert trace.counts()["reader.slot_allocs"] - before == 1
    assert pool.peak == pool.held == 1 << 27
    assert all(s.buf is None for free in pool._free.values() for s in free)


class _Hedged:
    """A client whose every block read makes two attempts: the first lands
    in its buffer and loses, the second returns; a losing attempt may go
    on writing after the read has returned."""

    def __init__(self, client):
        self.client = client
        self.losers = []

    def __getattr__(self, name):
        return getattr(self.client, name)

    async def _read_block_range(self, block, offset, length, *, into=None,
                                **kw):
        data = await self.client._read_block_range(block, offset, length,
                                                   **kw)
        self.losers.append(into(len(data)))
        won = into(len(data))
        won[:] = np.frombuffer(data, dtype=np.uint8)
        return won


def test_slot_of_a_losing_attempt_is_not_pooled(tmp_path):
    """The slot goes to the first attempt at a block; the returned bytes
    came from the second, so the slot is dropped, not pooled: the loser
    may still be writing there. The blocks land whole, through the
    pageable path."""
    client, _handles, metas, datas = _slot_layout(
        tmp_path, [("/h/a", 2 * SLOT_BLOCK + 7)])
    hedged = _Hedged(client)
    reader = port.HbmReader(hedged, [CPU])
    before = trace.counts().get("h2d.pageable_bytes", 0)
    blocks = asyncio.run(reader.read_file_to_device_blocks("/h/a"))
    assert _port_bytes(blocks) == datas["/h/a"]
    pool = reader._pools[CPU]
    assert len(hedged.losers) == 3 and pool.peak > 0
    assert pool.held == 0 and not any(pool._free.values())
    assert trace.counts()["h2d.pageable_bytes"] - before == \
        2 * SLOT_BLOCK + 512


@pytest.mark.parametrize("stall", ["before_into", "after_into"])
def test_slot_of_a_cancelled_read_is_not_written_under_its_next_owner(
        tmp_path, monkeypatch, stall):
    """A read cancelled while its worker is stalled, before or after it
    asks for its buffer, whose worker then goes on to write its block. The
    slot goes to a second block read without verify, and the first
    block's worker writes between the second's pread and its copy: the
    second block lands with its own bytes, and no slot stays taken."""
    monkeypatch.setattr(port, "SLOT_BUDGET", SLOT_BLOCK)
    client, _handles, metas, datas = _slot_layout(
        tmp_path, [("/c/a", SLOT_BLOCK), ("/c/b", SLOT_BLOCK)])
    a_id = metas["/c/a"]["blocks"][0]["block_id"]
    started, go, wrote = (threading.Event() for _ in range(3))
    for store, _ in client._local_stores.values():
        for name in ("read", "read_verified"):
            setattr(store, name, _stalled(getattr(store, name), a_id, started,
                                          go, wrote, stall == "before_into"))
    copy = port.reused_to_device

    def late_copy(src, device):
        # The cancelled read's worker writes between the pread and the copy.
        go.set()
        assert wrote.wait(10)
        return copy(src, device)

    reader = port.HbmReader(client, [CPU])

    async def scenario():
        first = asyncio.create_task(
            reader.read_file_to_device_blocks("/c/a"))
        assert await asyncio.to_thread(started.wait, 10)
        first.cancel()
        with pytest.raises(asyncio.CancelledError):
            await first
        monkeypatch.setattr(port, "reused_to_device", late_copy)
        return await reader.read_file_to_device_blocks("/c/b", verify=False)

    blocks = asyncio.run(asyncio.wait_for(scenario(), 60))
    assert wrote.is_set()
    assert _port_bytes(blocks) == datas["/c/b"]
    assert _taken(reader._pools[CPU]) == 0
