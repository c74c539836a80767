"""Port parity for the collective write group: ``tpudfs_torch.gpu.write_group``
against the JAX package's ``tpudfs.tpu.write_group``, on CPU positions.

Two parts. Unit cases drive the group with stand-in members (an address and
an ``async persist_ici_replica``): the power-of-two round bucket and its
zero-CRC padding slots, oldest-by-seq geometry, whole-round failures, a
member refusing its persist, ``stop()``, and the same submissions through
both packages' groups persisting the same bytes with the same counters.
Then the cases of ``tests/test_ici_write.py`` that exercise the group run
on ``MiniCluster`` with the port's group attached to the reference
chunkservers. Those catch the reference's ``IciWriteError``, so the tests
attach :class:`ShimGroup`, whose ``Error`` is that class."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from tests.test_master_service import MiniCluster
from tpudfs.client.client import Client
from tpudfs.tpu import write_group as ref_wg
from tpudfs.tpu.ici_replication import make_mesh as ref_make_mesh
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c
from tpudfs_torch.gpu import u32_to_numpy
from tpudfs_torch.gpu import write_group as port_wg
from tpudfs_torch.gpu.ici_replication import Mesh, make_mesh

CPU = torch.device("cpu")


class ShimGroup(port_wg.IciWriteGroup):
    """The port's group as the reference chunkserver catches its errors."""

    Error = ref_wg.IciWriteError


def _rand(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


class Member:
    """A stand-in member: persists into a dict; refuses every persist whose
    term is below ``fence`` (a stale fencing term)."""

    def __init__(self, address: str, fence: int = 0):
        self.address = address
        self.fence = fence
        self.persisted: dict[str, list[bytes]] = {}

    async def persist_ici_replica(self, block_id, data, master_term,
                                  master_shard) -> bool:
        if master_term < self.fence:
            return False
        self.persisted.setdefault(block_id, []).append(bytes(data))
        return True


def _port_group(n: int = 3, fences=None, cls=port_wg.IciWriteGroup):
    members = [Member(f"m{i}:1", (fences or {}).get(i, 0)) for i in range(n)]
    group = cls(make_mesh([CPU] * n), [m.address for m in members])
    for i, m in enumerate(members):
        group.attach(m, i)
    return group, members


def _spy(group) -> list:
    """Record the (words, crcs) of every round the group replicates."""
    seen = []
    real = group.replicator.replicate

    def spy(words, crcs):
        seen.append(([u32_to_numpy(w) for w in words],
                     [u32_to_numpy(c) for c in crcs]))
        return real(words, crcs)

    group.replicator.replicate = spy
    return seen


async def _settle(coros) -> list:
    return await asyncio.wait_for(
        asyncio.gather(*coros, return_exceptions=True), timeout=60)


# ------------------------------------------------------------- unit cases


async def test_round_pads_to_a_power_of_two_bucket():
    """3 blocks from one position and 1 from another ride ONE round of
    B=4 slots a position; empty slots hold zero words whose expected CRC is
    the zero-chunk CRC, and every member persists every block."""
    group, members = _port_group()
    seen = _spy(group)
    datas = {(0, f"b{j}"): _rand(1000, seed=j) for j in range(3)}
    datas[(1, "c0")] = _rand(1024, seed=9)
    try:
        got = await _settle(group.submit(pos, bid, d, 1, "s")
                            for (pos, bid), d in datas.items())
    finally:
        await group.stop()
    assert got == [3, 3, 3, 3]
    assert len(seen) == 1 and group.stats.rounds == 1
    words, crcs = seen[0]
    zero = crc32c(b"\x00" * CHECKSUM_CHUNK_SIZE)
    assert [w.shape for w in words] == [(8, 128)] * 3  # B=4 x cpb=2
    assert (crcs[2] == zero).all() and (words[2] == 0).all()
    assert (crcs[1][2:] == zero).all() and (crcs[0][6:] == zero).all()
    for m in members:
        assert m.persisted == {bid: [d] for (_, bid), d in datas.items()}
    assert group.stats.blocks == 4 and group.stats.bytes == 4024
    assert group.stats.last_acks == 3


async def test_geometry_follows_the_globally_oldest_block():
    """The first round takes the chunk count of the oldest pending block,
    here one on the LAST position, not that of the first busy queue; the
    other geometry follows in the next round."""
    group, _ = _port_group()
    seen = _spy(group)
    subs = [(2, "odd", _rand(3 * 512, seed=1))]
    subs += [(0, f"even{j}", _rand(2 * 512, seed=2 + j)) for j in range(3)]
    try:
        got = await _settle(group.submit(pos, bid, d, 1, "s")
                            for pos, bid, d in subs)
    finally:
        await group.stop()
    assert got == [3] * 4
    assert [ws[0].shape[0] for ws, _ in seen] == [3, 8]  # cpb 3 x B1, 2 x B4
    assert group.stats.round_failures == 0


@pytest.mark.parametrize("fault", ["raises", "poisoned_crc"])
async def test_round_failure_raises_the_groups_error(fault):
    """A device error, or a poisoned expected CRC (acks < positions), fails
    the whole round: every future raises ``Error``, nothing persists."""
    group, members = _port_group(cls=ShimGroup)
    real = group.replicator.replicate

    def broken(words, crcs):
        if fault == "raises":
            raise RuntimeError("injected device failure")
        crcs = [c.clone() for c in crcs]
        crcs[1].view(torch.int32)[0] ^= 0x5A5A5A5A
        return real(words, crcs)

    group.replicator.replicate = broken
    try:
        got = await _settle(group.submit(p, f"b{p}", _rand(700, seed=p), 1, "s")
                            for p in range(3))
    finally:
        await group.stop()
    assert all(isinstance(e, ref_wg.IciWriteError) for e in got), got
    assert group.stats.round_failures == 1 and group.stats.rounds == 0
    assert group.stats.last_acks == 0  # every position holds position 1's group
    assert all(not m.persisted for m in members)


async def test_refused_persist_counts_and_fails_the_source():
    """A member on a stale term refuses every replica it holds: its own
    block fails (its source copy is missing), the others resolve with the
    copies that were persisted, and each refusal counts."""
    group, members = _port_group(fences={1: 10})
    try:
        got = await _settle(group.submit(p, f"b{p}", _rand(600, seed=p), 5, "s")
                            for p in range(3))
    finally:
        await group.stop()
    assert got[0] == 2 and got[2] == 2
    assert isinstance(got[1], port_wg.IciWriteError)
    assert group.stats.persist_failures == 3  # member 1's three groups
    assert group.stats.blocks == 2 and not members[1].persisted


async def test_stop_fails_pending_and_later_submits():
    group, members = _port_group()
    group.ROUND_ACCUMULATE_S = 30.0  # the round never launches
    task = asyncio.create_task(group.submit(0, "b", _rand(512), 1, "s"))
    await asyncio.sleep(0.01)
    await group.stop()
    with pytest.raises(port_wg.IciWriteError, match="stopped"):
        await asyncio.wait_for(task, timeout=10)
    with pytest.raises(port_wg.IciWriteError, match="stopped"):
        await group.submit(0, "c", _rand(512), 1, "s")
    assert not group.healthy() and all(not m.persisted for m in members)


def test_surface_matches_the_reference():
    """Gauge names, round constants and the ring topology of a 2-ring mesh
    equal the reference's."""
    assert list(port_wg._RoundStats().as_gauges()) == \
        list(ref_wg._RoundStats().as_gauges())
    for name in ("MAX_BLOCKS_PER_ROUND", "ROUND_ACCUMULATE_S"):
        assert getattr(port_wg.IciWriteGroup, name) == \
            getattr(ref_wg.IciWriteGroup, name)
    assert port_wg._ZERO_CHUNK_CRC == ref_wg._ZERO_CHUNK_CRC
    from jax.sharding import Mesh as JaxMesh

    addrs = [f"h{i}:1" for i in range(8)]
    ref = ref_wg.IciWriteGroup(
        JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dcn", "ici")),
        addrs, replication=3)
    port = port_wg.IciWriteGroup(
        Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 4), ("dcn", "ici")),
        addrs, replication=3)
    for p in range(8):
        assert port.successors(p) == ref.successors(p)
        assert port.ring_of(p) == ref.ring_of(p)
    with pytest.raises(ValueError, match="members"):
        port_wg.IciWriteGroup(make_mesh([CPU] * 3), addrs[:2])


async def test_same_writes_through_both_groups_persist_the_same():
    """Mixed geometry from every position, through the reference group on
    three virtual JAX devices and the port's on three CPU positions: the
    same results, persisted bytes and counters."""
    subs = [(p, f"b{p}_{j}", _rand(512 * (2 + (p + j) % 2) - 37 * j,
                                   seed=10 * p + j))
            for p in range(3) for j in range(3)]

    async def run(group, members):
        for i, m in enumerate(members):
            group.attach(m, i)
        try:
            got = await _settle(group.submit(p, bid, d, 1, "s")
                                for p, bid, d in subs)
        finally:
            await group.stop()
        return got, [m.persisted for m in members], group.stats.as_gauges()

    ref_members = [Member(f"m{i}:1") for i in range(3)]
    ref = await run(ref_wg.IciWriteGroup(
        ref_make_mesh(jax.devices()[:3]), [m.address for m in ref_members]),
        ref_members)
    port_members = [Member(f"m{i}:1") for i in range(3)]
    port = await run(port_wg.IciWriteGroup(
        make_mesh([CPU] * 3), [m.address for m in port_members]),
        port_members)
    assert port[0] == ref[0] == [3] * 9
    assert port[1] == ref[1]
    assert port[2] == ref[2]


# ------------------------------------------- the reference's live cluster


async def _ici_cluster(tmp_path, n_cs: int = 3, replication: int = 3):
    """MiniCluster whose chunkservers form one port write group over n_cs
    CPU positions (Python data plane: the collective path lives in
    rpc_write_block)."""
    c = MiniCluster(tmp_path, n_masters=1, n_cs=n_cs,
                    cs_kw={"python_data_plane": True})
    await c.start()
    group = ShimGroup(make_mesh([CPU] * n_cs),
                      [cs.address for cs in c.chunkservers],
                      replication=replication)
    for i, cs in enumerate(c.chunkservers):
        cs.attach_ici_group(group, i)
    leader = await c.leader()
    await c.wait_out_of_safe_mode(leader)
    for hb in c.heartbeats:  # the master records the advertised ring
        await hb.tick()
    client = Client(list(c.masters), rpc_client=c.client,
                    block_size=64 * 1024)
    return c, group, client


async def _stop_all(c, group):
    await group.stop()
    await c.stop()


async def test_put_rides_collective_rounds(tmp_path):
    c, group, client = await _ici_cluster(tmp_path)
    try:
        data = _rand(3 * 64 * 1024 + 513, seed=1)  # 4 blocks, last partial
        await client.create_file("/ici/a", data)
        assert group.stats.rounds >= 1, "no collective round ran"
        assert group.stats.blocks == 4
        assert group.stats.round_failures == 0
        assert await client.get_file("/ici/a") == data
        info = await client.get_file_info("/ici/a")
        off = 0
        for b in info["blocks"]:
            size = int(b["size"])
            want = data[off : off + size]
            off += size
            for cs in c.chunkservers:
                assert cs.store.read_verified(b["block_id"]) == want
    finally:
        await _stop_all(c, group)


async def test_master_places_successor_chains(tmp_path):
    c, group, client = await _ici_cluster(tmp_path)
    try:
        leader = await c.leader()
        ring = [cs.address for cs in c.chunkservers]
        st = leader.state.chunk_servers[ring[0]]
        assert tuple(st.ici_ring) == tuple(ring)
        await client.create_file("/ici/chain", _rand(64 * 1024, seed=2))
        info = await client.get_file_info("/ici/chain")
        locs = list(info["blocks"][0]["locations"])
        i = ring.index(locs[0])
        assert locs == [ring[(i + j) % len(ring)] for j in range(3)]
    finally:
        await _stop_all(c, group)


async def test_metrics_expose_collective_counters(tmp_path):
    from tpudfs.common.ops_http import render_metrics

    c, group, client = await _ici_cluster(tmp_path)
    try:
        await client.create_file("/ici/m", _rand(128 * 1024, seed=3))
        text = render_metrics("tpudfs_cs", c.chunkservers[0].ops_gauges())
        assert "tpudfs_cs_ici_rounds_total 2.0" in text
        assert "tpudfs_cs_ici_blocks_total 2.0" in text
        assert "tpudfs_cs_ici_group_healthy 1.0" in text
    finally:
        await _stop_all(c, group)


async def test_dead_member_degrades_to_tcp_chain(tmp_path):
    c, group, client = await _ici_cluster(tmp_path)
    try:
        await client.create_file("/ici/pre", _rand(64 * 1024, seed=4))
        rounds_before = group.stats.rounds
        await c.chunkservers[2].stop()
        c.heartbeats[2].stop()
        assert not group.healthy()
        data = _rand(2 * 64 * 1024, seed=5)
        await client.create_file("/ici/post", data)
        assert group.stats.rounds == rounds_before, \
            "collective round ran with a dead member"
        assert sum(cs.ici_fallbacks for cs in c.chunkservers) >= 1
        assert await client.get_file("/ici/post") == data
    finally:
        await _stop_all(c, group)


async def test_round_failure_falls_back_transparently(tmp_path):
    c, group, client = await _ici_cluster(tmp_path)
    try:
        def boom(*a, **k):
            raise RuntimeError("injected device failure")

        group.replicator.replicate = boom
        data = _rand(64 * 1024, seed=6)
        await client.create_file("/ici/fb", data)
        assert group.stats.round_failures >= 1
        assert sum(cs.ici_fallbacks for cs in c.chunkservers) >= 1
        assert await client.get_file("/ici/fb") == data
    finally:
        await _stop_all(c, group)


async def test_non_ring_chain_takes_tcp_path(tmp_path):
    c, group, client = await _ici_cluster(tmp_path)
    try:
        cs0 = c.chunkservers[0]
        ring = [cs.address for cs in c.chunkservers]
        resp = await c.client.call(
            cs0.address, "ChunkServerService", "WriteBlock", {
                "block_id": "blk-nonring",
                "data": _rand(1024, seed=7),
                "next_servers": [ring[2], ring[1]],  # reversed successors
                "expected_crc32c": 0,
            }, timeout=10.0)
        assert resp["success"]
        assert cs0.ici_fallbacks >= 1
        assert group.stats.rounds == 0 or group.stats.blocks == 0
    finally:
        await _stop_all(c, group)


async def test_stale_term_fenced_at_persist(tmp_path):
    c, group, client = await _ici_cluster(tmp_path)
    try:
        shard = (await c.leader()).state.shard_id
        for cs in c.chunkservers:
            cs.observe_term(10_000, shard)
        with pytest.raises(Exception):
            await client.create_file("/ici/fenced", _rand(1024, seed=8))
        assert group.stats.blocks == 0
    finally:
        await _stop_all(c, group)


async def test_concurrent_puts_share_rounds(tmp_path):
    c, group, client = await _ici_cluster(tmp_path)
    try:
        datas = [_rand(64 * 1024, seed=10 + i) for i in range(8)]
        await asyncio.gather(*(client.create_file(f"/ici/c{i}", d)
                               for i, d in enumerate(datas)))
        assert group.stats.blocks == 8
        assert group.stats.rounds < 8, \
            f"no batching: {group.stats.rounds} rounds for 8 blocks"
        for i, d in enumerate(datas):
            assert await client.get_file(f"/ici/c{i}") == d
    finally:
        await _stop_all(c, group)


async def test_persist_crash_does_not_strand_writers(tmp_path):
    c, group, client = await _ici_cluster(tmp_path)
    try:
        async def boom(*a, **k):
            raise RuntimeError("injected persist crash")

        for cs in c.chunkservers:
            cs.persist_ici_replica = boom
        data = _rand(64 * 1024, seed=40)
        await asyncio.wait_for(client.create_file("/ici/crash", data),
                               timeout=30)
        assert group.stats.round_failures >= 1
        assert await client.get_file("/ici/crash") == data
    finally:
        await _stop_all(c, group)


async def test_mixed_geometry_blocks_are_not_starved(tmp_path):
    c, group, client = await _ici_cluster(tmp_path)
    try:
        datas = [_rand(64 * 1024 + 700 * (i % 3), seed=50 + i)
                 for i in range(6)]
        await asyncio.wait_for(asyncio.gather(*(
            client.create_file(f"/ici/mx{i}", d)
            for i, d in enumerate(datas))), timeout=60)
        for i, d in enumerate(datas):
            assert await client.get_file(f"/ici/mx{i}") == d
        assert group.stats.round_failures == 0
    finally:
        await _stop_all(c, group)


async def test_s3_put_rides_collective_rounds(tmp_path):
    from aiohttp.test_utils import TestClient, TestServer

    from tpudfs.s3.server import Gateway

    c, group, client = await _ici_cluster(tmp_path)
    try:
        tc = TestClient(TestServer(Gateway(client, auth_enabled=False)
                                   .build_app()))
        await tc.start_server()
        try:
            assert (await tc.put("/icibkt")).status in (200, 409)
            body = _rand(3 * 64 * 1024, seed=90)
            rounds_before = group.stats.rounds
            r = await tc.put("/icibkt/obj", data=body)
            assert r.status == 200, await r.text()
            assert group.stats.rounds > rounds_before, \
                "S3 PUT did not ride collective rounds"
            g = await tc.get("/icibkt/obj")
            assert g.status == 200
            assert await g.read() == body
        finally:
            await tc.close()
    finally:
        await _stop_all(c, group)
