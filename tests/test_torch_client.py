"""The port's own DFS client (``tpudfs_torch.client.client``) against the
reference's ``tpudfs.client.client.Client`` on the same ``MiniCluster`` at
64 KiB blocks: the same bytes from ``get_file``, ``read_file_range`` and
``read_meta_range`` at unaligned offsets, the same metadata, block
checksums and CRC-64 ETags, each client reading what the other wrote at 3x
and at RS(3,2), reads after chunkservers stop (the EC block through the
host decode), a 3-master cluster whose leader stops, the same error class
names; the port's device paths (``HbmReader``, the read combiner,
``CheckpointManager``, ``DfsTorchDataset`` in two spawned workers) driven
by it; a save's deadline and tenant reaching the master through it; its
``crc64nvme`` (native and plain) against the reference's; and, in a fresh
interpreter that refuses ``jax``, a process cluster of ``tpudfs_torch.cluster``
written and read into the CPU device with no ``tpudfs`` or ``jax`` module
loaded. Byte functions: no tolerance."""

from __future__ import annotations

import asyncio
import functools

import numpy as np
import pytest
import torch

from tests.test_master_service import MiniCluster
from tpudfs.client.client import Client as RefClient
from tpudfs.common import checksum as ref_checksum
from tpudfs.common import resilience as ref_resilience
from tpudfs.master.service import Master
from tpudfs.testing.ckptchaos import assert_restores_bit_exact, ckpt_tree
from tpudfs_torch.client.client import Client
from tpudfs_torch.common import checksum, trace
from tpudfs_torch.common import resilience as port_resilience
from tpudfs_torch.gpu.checkpoint import CheckpointManager
from tpudfs_torch.gpu.hbm_reader import HbmReader, device_array_to_bytes
from tpudfs_torch.gpu.torch_data import DfsTorchDataset
from torch_nojax import run_without_jax

CPU = torch.device("cpu")
BLOCK = 64 * 1024
RANGES = [(0, 1), (1, 65535), (65535, 3), (70_001, 100_000),
          (196_607, 2), (299_990, 100)]


def _rand(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


async def _cluster(tmp_path, n_cs: int = 5, n_masters: int = 1):
    """A started cluster out of safe mode, the port's client and the
    reference's, both at 64 KiB blocks with CRC-64 ETags."""
    c = MiniCluster(tmp_path, n_masters=n_masters, n_cs=n_cs)
    await c.start()
    await c.wait_out_of_safe_mode(await c.leader())
    port = Client(list(c.masters), block_size=BLOCK, etag_mode="crc64")
    ref = RefClient(list(c.masters), rpc_client=c.client, block_size=BLOCK,
                    etag_mode="crc64")
    return c, port, ref


async def _stop(c, *clients) -> None:
    for client in clients:
        await client.close()
    await c.stop()


def _layout(meta: dict) -> list:
    """A file's block list without its ids and placements."""
    return [{k: v for k, v in b.items() if k not in ("block_id", "locations")}
            for b in meta["blocks"]]


async def _same_reads(path: str, data: bytes, *clients) -> None:
    metas = [await cl.get_file_info(path) for cl in clients]
    assert all(m == metas[0] for m in metas)
    for cl in clients:
        assert await cl.get_file(path) == data
        for off, n in RANGES:
            assert await cl.read_file_range(path, off, n) == data[off:off + n]
            assert await cl.read_meta_range(metas[0], off, n) \
                == data[off:off + n]
        assert await cl.read_file_range(path, len(data) + 1, 5) == b""


# ------------------------------------------------------------- checksums


def test_crc64nvme_native_and_plain_equal_the_reference():
    rng = np.random.default_rng(0)
    lengths = [0, 1, 7, 8, 9, 4095, 65537,
               *rng.integers(0, 1 << 20, 3).tolist(), 1 << 20]
    for n in lengths:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = ref_checksum.crc64nvme(data)
        assert checksum.crc64nvme(data) == want, n
        assert checksum.crc64nvme_plain(data) == want, n
        cut = n // 3
        assert checksum.crc64nvme(data[cut:], checksum.crc64nvme(data[:cut])) \
            == want, n
    assert checksum.crc64nvme(b"123456789") == 0xAE8B14860A799888


# ------------------------------------------------------------ byte parity


@pytest.mark.parametrize("writer", ["port", "reference"])
async def test_each_client_reads_what_the_other_wrote(tmp_path, writer):
    """3x and RS(3,2) files written by one client: both clients return the
    same bytes and metadata, at unaligned offsets."""
    c, port, ref = await _cluster(tmp_path)
    try:
        w = port if writer == "port" else ref
        files = {"/x/rep": (_rand(300_001, 1), None),
                 "/x/ec": (_rand(300_001, 2), (3, 2)),
                 "/x/empty": (b"", None)}
        for path, (data, ec) in files.items():
            await w.create_file(path, data, ec=ec)
        for path, (data, _ec) in files.items():
            await _same_reads(path, data, port, ref)
        meta = await port.get_file_info("/x/ec")
        assert [b["ec_data_shards"] for b in meta["blocks"]] == [3] * 5
        assert sorted(await port.list_files("/x/")) \
            == sorted(await ref.list_files("/x/")) == sorted(files)
        listed = dict(await port.list_files_with_meta("/x/"))
        assert listed == dict(await ref.list_files_with_meta("/x/"))
        await port.delete_file("/x/empty")
        assert await ref.get_file_info("/x/empty") is None
    finally:
        await _stop(c, port)


async def test_same_metadata_checksums_and_crc64_etags(tmp_path):
    """The same bytes through each client: the same block sizes, CRC32Cs,
    EC shapes and CRC-64 ETag; md5 ETags match too."""
    c, port, ref = await _cluster(tmp_path)
    try:
        data = _rand(200_003, 3)
        for ec in (None, (3, 2)):
            await port.create_file(f"/m/port{ec}", data, ec=ec)
            await ref.create_file(f"/m/ref{ec}", data, ec=ec)
            a = await port.get_file_info(f"/m/port{ec}")
            b = await ref.get_file_info(f"/m/ref{ec}")
            assert _layout(a) == _layout(b)
            assert a["size"] == b["size"] == len(data)
            assert a["etag_md5"] == b["etag_md5"] \
                == f"{ref_checksum.crc64nvme(data):016x}-crc64"
        port.etag_mode = ref.etag_mode = "md5"
        await port.create_file("/m/port-md5", data)
        await ref.create_file("/m/ref-md5", data)
        assert (await port.get_file_info("/m/port-md5"))["etag_md5"] \
            == (await ref.get_file_info("/m/ref-md5"))["etag_md5"]
    finally:
        await _stop(c, port)


async def test_reads_after_chunkservers_stop(tmp_path):
    """Stop the holders of the EC file's first two data shards: the 3x file
    reads from its surviving replicas and every EC block that lost a data
    shard decodes on the host, through both clients. The port's client
    also lands each EC block's shards in the device reader's rows, three
    a block, and the blocks come out whole."""
    c, port, ref = await _cluster(tmp_path)
    try:
        rep, ec = _rand(300_001, 4), _rand(300_001, 5)
        await port.create_file("/f/rep", rep)
        await port.create_file("/f/ec", ec, ec=(3, 2))
        meta = await port.get_file_info("/f/ec")
        victims = meta["blocks"][0]["locations"][:2]
        for i, cs in enumerate(c.chunkservers):
            if cs.address in victims:
                c.heartbeats[i].stop()
                await cs.stop()
        assert await port.get_file("/f/rep") == rep
        assert await ref.get_file("/f/rep") == rep
        for cl in (port, ref):
            assert await cl.get_file("/f/ec") == ec
            assert await cl.read_file_range("/f/ec", 70_001, 100_000) \
                == ec[70_001:170_001]
        shards = await port._read_ec_shards(meta["blocks"][0])
        assert shards[0] is None and shards[1] is None
        assert await port._read_ec_block(meta["blocks"][0]) == ec[:BLOCK]
        counts = ("ec.rows_landed", "ec.rows_copied", "ec.shard_bytes")
        before = trace.counts()
        blocks = await HbmReader(port, [CPU]).read_file_to_device_blocks(
            "/f/ec")
        moved = {n: trace.counts().get(n, 0) - before.get(n, 0)
                 for n in counts}
        assert b"".join(device_array_to_bytes(b.array, b.size)
                        for b in blocks) == ec
        assert moved["ec.rows_landed"] + moved["ec.rows_copied"] == \
            3 * len(blocks)
        assert moved["ec.shard_bytes"] == sum(
            3 * -(-b["size"] // 3) for b in meta["blocks"])
    finally:
        await _stop(c, port)


async def test_leader_failover_follows_hints(tmp_path):
    """A 3-master cluster: a client given the followers first reaches the
    leader through its Not-Leader hint; the leader stops, and the client
    writes and reads through the new one."""
    c, port, ref = await _cluster(tmp_path, n_cs=3, n_masters=3)
    try:
        leader = await c.leader()
        port.master_addrs = [a for a in c.masters if a != leader.address] \
            + [leader.address]
        before = _rand(100_000, 6)
        await port.create_file("/ha/before", before)
        await leader.stop()
        await c.servers[leader.address].stop()
        del c.masters[leader.address]
        await c.wait_out_of_safe_mode(await c.leader(timeout=15.0))
        after = _rand(150_000, 7)
        await port.create_file("/ha/after", after)
        for cl in (port, ref):
            assert await cl.get_file("/ha/before") == before
            assert await cl.get_file("/ha/after") == after
    finally:
        await _stop(c, port)


async def test_errors_have_the_reference_class_names(tmp_path):
    c, port, ref = await _cluster(tmp_path, n_cs=3)
    try:
        for call in (lambda cl: cl.get_file("/nope"),
                     lambda cl: cl.read_file_range("/nope", 0, 1),
                     lambda cl: cl._read_block_range(
                         {"block_id": "blk-x", "locations": []}, 0, 0)):
            names = []
            for cl in (port, ref):
                with pytest.raises(Exception) as ei:
                    await call(cl)
                names.append([k.__name__ for k in type(ei.value).__mro__])
            assert names[0][:2] == names[1][:2] == ["DfsError", "Exception"]
        assert await port.get_file_info("/nope") is None
        with pytest.raises(ValueError):
            Client()
    finally:
        await _stop(c, port)


# ------------------------------------------------------- the port's paths


async def test_device_readers_give_the_same_bytes(tmp_path):
    """``HbmReader`` per block (lazy verify, one confirm) and through the
    read combiner, over the wire and short-circuited: the same bytes with
    the port's client as with the reference's."""
    c, port, ref = await _cluster(tmp_path)
    try:
        files = {"/d/rep": _rand(300_001, 8), "/d/ec": _rand(200_000, 9)}
        await port.create_file("/d/rep", files["/d/rep"])
        await port.create_file("/d/ec", files["/d/ec"], ec=(3, 2))
        for local in (False, True):
            for batch in (0, 4):
                got = {}
                for name, cl in (("port", port), ("ref", ref)):
                    cl.local_reads = local
                    reader = HbmReader(cl, [CPU], batch_reads=batch)
                    out = {}
                    for path in files:
                        blocks = await reader.read_file_to_device_blocks(
                            path, verify="lazy")
                        await reader.confirm(blocks)
                        assert all(b.verified for b in blocks)
                        out[path] = b"".join(device_array_to_bytes(
                            b.array, b.size) for b in blocks)
                    got[name] = out
                assert got["port"] == got["ref"] == files, (local, batch)
        assert port.local_read_blocks > 0
    finally:
        await _stop(c, port)


async def test_checkpoint_round_trip_through_both_clients(tmp_path):
    """The port's manager saves through the port's client (its default
    scopes); it restores into the CPU device through the port's client and
    through the reference's, bit-exact."""
    c, port, ref = await _cluster(tmp_path)
    try:
        trees = {s: ckpt_tree(1, s, kib=64) for s in range(2)}
        mgr = CheckpointManager(port, "/ck", num_shards=2, ec=(3, 2),
                                reader=HbmReader(port, [CPU]))
        await mgr.save(1, trees)
        assert_restores_bit_exact(await mgr.restore(1), 1, kib=64)
        on_cpu = await mgr.restore(1, device=CPU)
        via_ref = CheckpointManager(ref, "/ck", num_shards=2, ec=(3, 2),
                                    reader=HbmReader(ref, [CPU]),
                                    scopes=ref_resilience)
        ref_cpu = await via_ref.restore(1, device=CPU)
        for s in range(2):
            for name, t in on_cpu[s].items():
                assert t.device == CPU
                assert torch.equal(t, ref_cpu[s][name])
                np.testing.assert_array_equal(t.numpy(), trees[s][name])
    finally:
        await _stop(c, port)


async def test_torch_dataset_in_spawned_workers(tmp_path):
    """``DfsTorchDataset`` over the port's client: two spawned loader
    workers each build a client from the pickled factory and give the rows
    the reference's client gives in this process."""
    c, port, ref = await _cluster(tmp_path, n_cs=3)
    try:
        paths = ["/t/a", "/t/b"]
        for i, path in enumerate(paths):
            await port.create_file(path, _rand(64 * 40, 10 + i))
        masters = list(c.masters)

        def load(factory, workers: int) -> np.ndarray:
            ds = DfsTorchDataset(factory, paths, 64, dtype="uint8")
            try:
                kw = {"multiprocessing_context": "spawn"} if workers else {}
                loader = torch.utils.data.DataLoader(
                    ds, batch_size=16, num_workers=workers, **kw)
                return torch.cat(list(loader)).numpy()
            finally:
                ds.close()

        got = await asyncio.to_thread(
            load, functools.partial(Client, masters, block_size=BLOCK), 2)
        want = await asyncio.to_thread(
            load, functools.partial(RefClient, masters, block_size=BLOCK), 0)
        assert got.shape == (80, 64)
        np.testing.assert_array_equal(got, want)
    finally:
        await _stop(c, port)


@pytest.mark.parametrize("which", ["port", "reference"])
async def test_a_saves_deadline_and_tenant_reach_the_master(tmp_path,
                                                            monkeypatch,
                                                            which):
    """The manager's save budget and tenant ride the client's RPC metadata
    (``x-deadline-budget``, ``x-tenant``) to the master, where its
    ``PublishCheckpoint`` handler sees them: through the port's client with
    the manager's default scopes as through the reference's with its own."""
    seen = []
    publish = Master.rpc_publish_checkpoint

    async def spy(self, req):
        seen.append((ref_resilience.remaining_budget(),
                     ref_resilience.current_tenant()))
        return await publish(self, req)

    monkeypatch.setattr(Master, "rpc_publish_checkpoint", spy)
    c, port, ref = await _cluster(tmp_path, n_cs=3)
    try:
        client = port if which == "port" else ref
        kw = {} if which == "port" else {"scopes": ref_resilience}
        mgr = CheckpointManager(client, "/dl", num_shards=1, ec=None,
                                save_budget_s=30.0, tenant="job-7", **kw)
        await mgr.save(1, {0: ckpt_tree(1, 0, kib=16)})
        budget, tenant = seen[-1]
        assert budget is not None and 0 < budget <= 30.0
        assert tenant == "job-7"
        # The scope ends with the save.
        assert port_resilience.remaining_budget() is None
        assert ref_resilience.remaining_budget() is None
    finally:
        await _stop(c, port)


# ------------------------------------------------------ a process cluster


def test_process_cluster_without_tpudfs_or_jax(tmp_path):
    """In a fresh interpreter that refuses ``jax``: a ``ProcessCluster`` of 1
    master and 3 chunkservers, a 3x and an RS(2,1) file written through the
    port's client and read into the CPU device, bit-exact, over the wire
    and short-circuited; no ``tpudfs`` or ``jax`` module loaded."""
    r = run_without_jax(f"""
        import asyncio, os, sys
        from pathlib import Path
        import torch
        from tpudfs_torch.client.client import Client
        from tpudfs_torch.cluster import ProcessCluster
        from tpudfs_torch.gpu.hbm_reader import HbmReader, device_array_to_bytes

        data = {{"/p/rep": os.urandom(300_001), "/p/ec": os.urandom(200_000)}}

        async def run(master):
            client = Client([master], block_size=65536, etag_mode="crc64")
            try:
                await client.create_file("/p/rep", data["/p/rep"])
                await client.create_file("/p/ec", data["/p/ec"], ec=(2, 1))
                out = {{}}
                for local in (False, True):
                    client.local_reads = local
                    reader = HbmReader(client, [torch.device("cpu")])
                    for path, want in data.items():
                        blocks = await reader.read_file_to_device_blocks(
                            path, verify="lazy")
                        await reader.confirm(blocks)
                        got = b"".join(device_array_to_bytes(b.array, b.size)
                                       for b in blocks)
                        out[f"{{path}}@{{local}}"] = got == want
                out["local_blocks"] = client.local_read_blocks
                return out
            finally:
                await client.close()

        with ProcessCluster(Path({str(tmp_path)!r}), n_cs=3) as cluster:
            result = asyncio.run(run(cluster.master_addr))
            result["servers"] = len(cluster.procs)
            result["alive"] = sum(p.poll() is None for p in cluster.procs)
        result["dead_after"] = sum(p.poll() is None for p in cluster.procs)
        result["tpudfs"] = sorted(m for m in sys.modules
                                  if m == "tpudfs" or m.startswith("tpudfs."))
    """, timeout=150)
    assert r["loaded_jax"] == [] and r["tpudfs"] == []
    assert (r["servers"], r["alive"], r["dead_after"]) == (4, 4, 0)
    for key in ("/p/rep@False", "/p/ec@False", "/p/rep@True", "/p/ec@True"):
        assert r[key] is True, key
    assert r["local_blocks"] > 0


@pytest.mark.parametrize("read", ["get_file", "read_file_range"])
async def test_a_block_list_short_of_the_size_is_refused(read):
    """A complete file whose block list holds fewer bytes than its size
    (what a master that lost a block's metadata answers: a rare leader
    failover of ``test_leader_failover_follows_hints`` does it with either
    client, ``tests/torch_failover_repeat.py``). The reference returns the
    short read as the file; the port raises ``DfsError`` naming the bytes
    its blocks hold."""
    meta = {"path": "/short", "size": 100_000, "complete": True,
            "blocks": [{"block_id": "blk-1", "size": BLOCK,
                        "locations": ["127.0.0.1:1"], "ec_data_shards": 0,
                        "ec_parity_shards": 0, "checksum_crc32c": 0}]}
    data = _rand(BLOCK, 11)
    got = {}
    for name, cls in (("port", Client), ("ref", RefClient)):
        client = cls(["127.0.0.1:1"], block_size=BLOCK)

        async def info(path, meta=meta):
            return meta

        async def block(b, off=0, length=0, *a, **kw):
            return data[off: off + (length or BLOCK)]

        client.get_file_info = info
        client._read_block = block
        client._read_block_range = block
        try:
            if read == "get_file":
                got[name] = await client.get_file("/short")
            else:
                got[name] = await client.read_file_range("/short", 0,
                                                         100_000)
        except Exception as e:
            got[name] = e
        finally:
            await client.close()
    assert got["ref"] == data
    assert type(got["port"]).__name__ == "DfsError"
    assert "hold 65536 of its 100000 bytes" in str(got["port"])
