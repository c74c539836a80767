"""Port parity for the verified read into device memory:
``tpudfs_torch.gpu.hbm_reader.HbmReader`` on the CPU device against the JAX
reference ``tpudfs.tpu.hbm_reader.HbmReader``, both reading the same files
through the same real ``tpudfs.client.Client`` on an in-process
``MiniCluster``: bytes, ``verified`` flags and lazily confirmed CRCs must
agree exactly. Also the short-circuit ``LocalClient`` over block stores
written by one package and read by the other."""

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
from tpudfs_torch.gpu import hbm_reader as port
from tpudfs_torch.gpu import u32_to_numpy

CPU = torch.device("cpu")


def _rand(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _joined(blocks, to_bytes):
    return b"".join(to_bytes(b.array, b.size) for b in blocks)


def _port_bytes(blocks):
    return _joined(blocks, port.device_array_to_bytes)


def _ref_bytes(blocks):
    return _joined(blocks, ref.device_array_to_bytes)


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
    """Degraded EC read around two stopped chunkservers: the k survivors
    are rebuilt by the GF(2^8) twin, and the device fold verifies them."""
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
        mine = await ours.read_file_to_device_blocks("/ec/dev")
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


async def test_read_meta_blocks_fast_matches_general_path(tmp_path):
    data = _rand(6 * 64 * 1024 + 100, seed=30)
    c, client = await _cluster(tmp_path, [("/wf/a", data)], local_reads=True)
    try:
        reader = port.HbmReader(client, [CPU])
        meta = await client.get_file_info("/wf/a")
        prime = await reader.read_file_to_device_blocks("/wf/a", verify="lazy")
        await reader.confirm(prime)
        blocks = await reader.read_meta_blocks_fast(meta)
        await reader.confirm(blocks)
        assert all(b.verified for b in blocks)
        assert _port_bytes(blocks) == data
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
