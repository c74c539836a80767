"""The port's client on a sharded deployment, held against the reference's
``Client`` on the same cluster: the reference's config server, two
single-master shards (``shard-z``, registered second, owns the keys up to
``/m``, the bootstrap split) and 3 chunkservers, in process
(``tests/test_cross_shard.py::ShardedCluster``). A client given only the
other shard's masters follows ``REDIRECT:`` to the owner and refreshes
its shard map; listings fan out over both shards; a cross-shard
``rename_file`` commits, and aborts with the reference's error class when
the destination exists; the admin calls answer as the reference's do (the
Raft membership calls on a 3-master ``MiniCluster``); both packages'
``CheckpointManager`` read each other's steps bit-exact on either shard.
Then the fault tier's plan (``kill_plan(..., shards=)``: the roulette's
rules, partitions included; without ``shards`` the plans of before) and ``find_leader_async``
during an election. Byte functions: no tolerance."""

from __future__ import annotations

import asyncio
import random

import numpy as np
import pytest
import torch

from tests.test_cross_shard import ShardedCluster
from tests.test_master_service import MiniCluster
from tpudfs.client.client import Client as RefClient
from tpudfs.common.rpc import RpcError
from tpudfs.tpu import checkpoint as ref_ckpt
from tpudfs_torch import ckpt_chaos as cc
from tpudfs_torch.client.client import Client
from tpudfs_torch.cluster import find_leader_async
from tpudfs_torch.gpu.checkpoint import CheckpointManager
from tpudfs_torch.gpu.hbm_reader import HbmReader
from torch_nojax import run_without_jax

CPU = torch.device("cpu")
BLOCK = 64 * 1024


def _rand(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


async def _sharded(tmp_path, masters: str | None = None):
    """A started sharded cluster and a port and a reference client, both
    with the config server and at 64 KiB blocks; ``masters`` names the
    one shard whose masters the clients are given (all when None)."""
    c = await ShardedCluster(tmp_path).start()
    addrs = [m.address for sid, m in sorted(c.masters.items())
             if masters in (None, sid)]
    port = Client(addrs, config_addrs=[c.cfg_addr], block_size=BLOCK)
    ref = RefClient(addrs, config_addrs=[c.cfg_addr], block_size=BLOCK)
    return c, port, ref


async def _stop(c, *clients) -> None:
    for client in clients:
        await client.close()
    await c.stop()


def _owner(c, path: str) -> str:
    return c.client.shard_map.get_shard(path)


def _names(exc: BaseException) -> list[str]:
    return [k.__name__ for k in type(exc).__mro__]


@pytest.mark.parametrize("writer", ["port", "reference"])
async def test_a_client_given_one_shard_follows_redirect(tmp_path, writer):
    """Both clients know only the masters of the shard that does not own
    ``/a/``: the writer's CreateFile is redirected to the owner, its map
    refreshed; each client reads what the other wrote."""
    c, port, ref = await _sharded(tmp_path, masters="shard-a")
    try:
        owner, other = _owner(c, "/a/w"), "shard-a"
        assert owner == "shard-z" and port.shard_map is None
        w = port if writer == "port" else ref
        data = _rand(200_003, 1)
        await w.create_file("/a/w", data)
        assert w.shard_map is not None
        assert w.shard_map.get_shard("/a/w") == owner
        assert "/a/w" in c.masters[owner].state.files
        assert "/a/w" not in c.masters[other].state.files
        for cl in (port, ref):
            assert await cl.get_file("/a/w") == data
            assert await cl.read_file_range("/a/w", 70_001, 100) \
                == data[70_001:70_101]
        assert await port.get_file_info("/a/w") \
            == await ref.get_file_info("/a/w")
    finally:
        await _stop(c, port)


async def test_listing_spans_both_shards(tmp_path):
    """``list_files_with_meta("/")`` gives the same list on both clients,
    with files of both shards, and equals the union of each shard's own
    ``ListFiles``."""
    c, port, ref = await _sharded(tmp_path)
    try:
        paths = ["/a/one", "/b/two", "/x/three", "/z/four"]
        for i, path in enumerate(paths):
            await (port if i % 2 else ref).create_file(path, _rand(999, i))
        assert {_owner(c, p) for p in paths} == {"shard-a", "shard-z"}
        listed = await port.list_files_with_meta("/")
        assert listed == await ref.list_files_with_meta("/")
        assert [p for p, _ in listed] == sorted(paths)
        assert all(meta["size"] == 999 for _, meta in listed)
        union = []
        for m in c.masters.values():
            resp = await c.rpc.call(m.address, "MasterService", "ListFiles",
                                    {"path": "/", "with_meta": False})
            union += resp["files"]
        assert sorted(union) == await port.list_files("/")
    finally:
        await _stop(c, port)


async def test_cross_shard_rename_commits_and_aborts(tmp_path):
    """The port's ``rename_file`` moves a file's metadata to the other
    shard (both transaction records committed); onto an existing
    destination it aborts, raising the reference's error classes, and
    leaves both files as they were."""
    c, port, ref = await _sharded(tmp_path)
    try:
        data = _rand(150_000, 3)
        await port.create_file("/a/src.bin", data)
        await port.rename_file("/a/src.bin", "/z/dst.bin")
        src_m, dst_m = c.master_of("/a/src.bin"), c.master_of("/z/dst.bin")
        assert src_m is not dst_m
        assert "/a/src.bin" not in src_m.state.files
        assert "/z/dst.bin" in dst_m.state.files
        assert await ref.get_file("/z/dst.bin") == data
        (ctx,) = src_m.state.transactions.values()
        (ptx,) = dst_m.state.transactions.values()
        assert ctx["state"] == ptx["state"] == "committed"
        assert ctx["participant_acked"] and ctx["txid"] == ptx["txid"]

        await port.create_file("/a/s", b"src")
        await port.create_file("/z/d", b"already here")
        names = []
        for cl in (port, ref):
            with pytest.raises(Exception) as ei:
                await cl.rename_file("/a/s", "/z/d")
            names.append(_names(ei.value)[:2])
        assert names[0] == names[1] == ["DfsError", "Exception"]
        assert await ref.get_file("/a/s") == b"src"
        assert await port.get_file("/z/d") == b"already here"
        assert sorted(t["state"] for t in
                      c.master_of("/a/s").state.transactions.values()) \
            == ["aborted", "aborted", "committed"]
        # replace=True swaps the destination out, as the reference's does.
        await port.rename_file("/a/s", "/z/d", replace=True)
        assert await ref.get_file("/z/d") == b"src"
        assert await ref.get_file_info("/a/s") is None
    finally:
        await _stop(c, port)


async def test_safe_mode_shuffle_and_raft_state_answer_as_the_reference(
        tmp_path):
    """``safe_mode_status``, ``set_safe_mode``, ``initiate_shuffle`` and
    ``raft_state`` on the sharded cluster: the same answers through both
    clients, and each client sees what the other set."""
    c, port, ref = await _sharded(tmp_path)
    try:
        a, b = await port.safe_mode_status(), await ref.safe_mode_status()
        assert sorted(a) == sorted(b) == ["reported_blocks", "safe_mode",
                                          "total_blocks"]
        assert a["safe_mode"] is b["safe_mode"] is False
        # The first master is the one both clients ask. A chunkserver's
        # heartbeat takes it out of safe mode again once enough blocks are
        # reported, so entry is read off the master's entry stamp.
        first = next(m for m in c.masters.values()
                     if m.address == port.master_addrs[0])
        for setter in (port, ref):
            stamp = first.state.safe_mode_entered_ms
            await asyncio.sleep(0.01)
            assert await setter.set_safe_mode(True) is None
            assert first.state.safe_mode_entered_ms > stamp
            assert await setter.set_safe_mode(False) is None
            assert first.state.safe_mode is False
            for reader in (port, ref):
                assert (await reader.safe_mode_status())["safe_mode"] \
                    is False
        for prefix in ("/a/", "/z/"):
            assert await port.initiate_shuffle(prefix) is None
            assert await ref.initiate_shuffle(prefix) is None
        for m in c.masters.values():
            p, r = await port.raft_state(m.address), \
                await ref.raft_state(m.address)
            assert sorted(p) == sorted(r)
            for key in ("node_id", "role", "term", "leader_id", "config"):
                assert p[key] == r[key], key
            assert p["role"] == "leader" and p["node_id"] == m.address
    finally:
        await _stop(c, port)


async def test_raft_membership_calls_answer_as_the_reference(tmp_path):
    """On a 3-master group: the port's ``cluster_transfer_leadership``
    hands the lead to a follower and the reference's hands it back; the
    port removes a follower and the reference adds it again (each seen in
    the leader's Raft config through the other client); a call the leader
    refuses raises the same error classes through both clients."""
    c = MiniCluster(tmp_path, n_masters=3, n_cs=3)
    await c.start()
    addrs = list(c.masters)
    port = Client(addrs, block_size=BLOCK)
    ref = RefClient(addrs, rpc_client=c.client, block_size=BLOCK)
    try:
        first = (await c.leader()).address
        follower = next(a for a in addrs if a != first)
        await port.cluster_transfer_leadership(follower)
        assert await find_leader_async([follower], client=ref,
                                       timeout=10.0) == follower
        await ref.cluster_transfer_leadership(first)
        assert await find_leader_async([first], client=port,
                                       timeout=10.0) == first

        async def voters(client) -> list[str]:
            leader = await find_leader_async(addrs, client=client,
                                             timeout=10.0)
            cfg = (await client.raft_state(leader))["config"]
            return sorted(cfg["voters"]) if not cfg.get("voters_old") \
                else []

        async def until_voters(client, want) -> None:
            for _ in range(100):
                if await voters(client) == sorted(want):
                    return
                await asyncio.sleep(0.1)
            raise AssertionError(f"voters never became {sorted(want)}")

        await port.cluster_remove_server(follower)
        await until_voters(ref, [a for a in addrs if a != follower])
        await ref.cluster_add_server(follower)
        await until_voters(port, addrs)

        for call in (lambda cl: cl.cluster_add_server(first),
                     lambda cl: cl.cluster_remove_server("127.0.0.1:1"),
                     lambda cl: cl.cluster_transfer_leadership(
                         "127.0.0.1:1")):
            names = []
            for cl in (port, ref):
                with pytest.raises(Exception) as ei:
                    await call(cl)
                names.append(_names(ei.value)[:2])
            assert names[0] == names[1] == ["DfsError", "Exception"]
    finally:
        await port.close()
        await c.stop()


@pytest.mark.parametrize("base", ["/a/ckpt", "/z/ckpt"])
async def test_checkpoints_cross_both_packages_on_either_shard(tmp_path,
                                                               base):
    """The port's manager (the port's client) and the reference's (the
    reference's client) save, publish and list steps at ``base`` on the
    shard that owns it; each restores the other's steps bit-exact, the
    port's into the CPU device through its reader."""
    c, port, ref = await _sharded(tmp_path)
    try:
        mine = CheckpointManager(port, base, num_shards=2, ec=(2, 1),
                                 reader=HbmReader(port, [CPU]))
        theirs = ref_ckpt.CheckpointManager(ref, base, num_shards=2,
                                            ec=(2, 1))
        trees = {s: {sh: cc.ckpt_tree(s, sh, kib=64) for sh in range(2)}
                 for s in (1, 2, 3)}
        await mine.save(1, trees[1])
        await theirs.save(2, trees[2])
        await mine.save(3, trees[3])
        assert await mine.list_steps() == await theirs.list_steps() \
            == [1, 2, 3]
        owner = _owner(c, base + "/MANIFEST-1")
        assert any(p.startswith(base) for p in c.masters[owner].state.files)
        for step in (1, 2, 3):
            cc.assert_restores_bit_exact(
                await mine.restore(step, device=CPU), step, kib=64)
            cc.assert_restores_bit_exact(await theirs.restore(step), step,
                                         kib=64)
        assert mine.stats["commits"] == 2
    finally:
        await _stop(c, port)


# ----------------------------------------------------- the fault tier plan


SHARDS = {"shard-0": ["m0", "m1", "m2"], "shard-z": ["m3", "m4", "m5"],
          "solo": ["m6"]}


def test_kill_plan_with_shards_follows_the_roulettes_rules():
    """Two to four faults a plan, at most two chunkservers, at most one
    master a group of 3 or more (none of a 1-master shard), partitions of
    any shard for 1.5 to 4 s, offsets in order from ``first``; leaders
    about 70% of the master kills; seeded."""
    names = [f"cs{i}" for i in range(5)]
    plans = [cc.kill_plan(random.Random(s), names, shards=SHARDS)
             for s in range(200)]
    assert plans[7] == cc.kill_plan(random.Random(7), names, shards=SHARDS)
    leaders = masters = 0
    for p in plans:
        offsets = [t for t, _ in p]
        assert offsets == sorted(offsets) and 1.0 <= offsets[0] <= 3.0
        assert 2 <= len(p) <= 4
        cs = [v for _, v in p if isinstance(v, str)]
        ms = [v for _, v in p if isinstance(v, cc.MasterKill)]
        parts = [v for _, v in p if isinstance(v, cc.Partition)]
        assert len(cs) + len(ms) + len(parts) == len(p)
        assert len(cs) == len(set(cs)) <= 2 and set(cs) <= set(names)
        assert len(ms) == len({m.shard for m in ms})
        assert {m.shard for m in ms} <= {"shard-0", "shard-z"}
        assert all(v.shard in SHARDS and 1.5 <= v.duration <= 4.0
                   for v in parts)
        masters += len(ms)
        leaders += sum(m.leader for m in ms)
    assert any(isinstance(v, cc.MasterKill) for p in plans for _, v in p)
    assert any(isinstance(v, cc.Partition) for p in plans for _, v in p)
    assert 0.6 < leaders / masters < 0.8


def test_kill_plan_without_shards_is_unchanged():
    """A seed gives the chunkserver-only plan it gave before ``shards=``
    (the values are pinned)."""
    names = [f"cs{i}" for i in range(5)]
    assert cc.kill_plan(random.Random(3), names) == [
        (1.4759292541837827, "cs2")]
    assert cc.kill_plan(random.Random(10), names) == [
        (2.142805189379827, "cs3"), (4.298987791648768, "cs1")]
    assert cc.kill_plan(random.Random(3), names) \
        == cc.kill_plan(random.Random(3), names, shards=None)


async def test_run_kill_plan_sends_each_kind_to_its_callback():
    plan = [(0.0, "cs1"), (0.01, cc.MasterKill("shard-z", True)),
            (0.02, cc.MasterKill("shard-0", False))]
    seen = []

    async def kill_master(shard, leader):
        seen.append(("master", shard, leader))
        return None if shard == "shard-0" else (f"{shard}-m0", "addr")

    done = await cc.run_kill_plan(plan, lambda v: seen.append(("cs", v)),
                                  kill_master)
    assert seen == [("cs", "cs1"), ("master", "shard-z", True),
                    ("master", "shard-0", False)]
    assert [d["killed"] for d in done] == ["cs1", ("shard-z-m0", "addr"),
                                            None]
    with pytest.raises(ValueError, match="kill_master"):
        await cc.run_kill_plan(plan[1:], lambda v: None)


async def test_find_leader_async_is_none_during_an_election(tmp_path):
    """A 3-master group whose leader stops: asked at once, no survivor
    leads (``None``); given an election's time, one does."""
    c = MiniCluster(tmp_path, n_masters=3, n_cs=1)
    await c.start()
    try:
        addrs = list(c.masters)
        leader = await c.leader()
        assert await find_leader_async(addrs, timeout=5.0) == leader.address
        await leader.stop()
        await c.servers[leader.address].stop()
        del c.masters[leader.address]
        survivors = [a for a in addrs if a != leader.address]
        assert await find_leader_async(survivors, timeout=0.0) is None
        new = await find_leader_async(survivors, timeout=15.0)
        assert new in survivors
        with pytest.raises(RpcError):
            await c.client.call(leader.address, "MasterService",
                                "RaftState", {}, timeout=1.0)
    finally:
        await c.stop()


def test_sharded_phase_small_on_cpu(tmp_path):
    """``chip_smoke.sharded_phase`` at a small size in an interpreter that
    refuses ``jax``: the Helm chart's deployment under TLS (3 config
    servers, ``shard-a`` and ``shard-z`` of 3 masters, a spare group of 3,
    5 chunkservers, each blockport the native engine), the cross-shard
    rename, step 2 published through a SIGKILLed leader, the listing
    across shards, the restores bit-exact, ``/a/`` split to the spare
    group under 20 metadata calls a second (the masters' split threshold
    lowered to 5 a second and their cooldown to 2 s, so that the split
    comes within seconds; the card runs the chart's 100 and 30 s) with a
    restore through the long-lived client's old map following a
    redirect, every infeed batch exact through a second SIGKILLed leader,
    the config leader SIGKILLed before the degraded restore (every block
    that lost a data shard rebuilt), a replica flipped on disk that only
    the chunkservers' scrubber reads (every 3 s here, the chart's 60 s on
    the card) reported in its holder's log; no ``tpudfs`` or ``jax``
    module."""
    r = run_without_jax(f"""
        from pathlib import Path
        import torch
        import chip_smoke
        result = chip_smoke.sharded_phase(
            torch.device("cpu"), params=40_000, file_bytes=1 << 20,
            block_size=65536, batches=10, num_workers=0, split_rps=5,
            split_cooldown_s=2, traffic_ops=20, scrub_interval_s=3,
            workdir=Path({str(tmp_path)!r}))
    """, timeout=150)
    assert r["loaded_jax"] == [] and r["foreign_modules"] == []
    assert r["topology"] == "helm-chart" and r["tls"]
    assert r["config_servers"] == 3 and len(r["spare_groups"]) == 1
    split = r["split"]
    assert split["from"] == "shard-z" and split["to"].startswith(
        "shard-z-split-")
    assert {k: len(v) for k, v in r["shards"].items()} \
        == {"shard-a": 3, "shard-z": 3, split["to"]: 3}
    assert sorted(split["voters"]) == sorted(r["spare_groups"][0]) \
        == sorted(r["shards"][split["to"]])
    assert list(r["engines"].values()) == [True] * 5
    assert r["dataset"]["from"][1] != r["dataset"]["to"][1]
    save = r["save"]
    assert save["shard"] == "shard-z" and len(r["save_gbps"]) == 2
    assert save["failover"]["killed"]["leader"]
    assert save["failover"]["new_leader"] in r["shards"]["shard-z"]
    assert r["failover_s"] > 0 and r["split_s"] > 0
    assert split["restores"] and split["map_version"][1] \
        > split["map_version"][0]
    stale = split["stale_map_restore"]
    assert stale["redirects"] >= 1 and stale["map_refreshes"] >= 1
    assert stale["map_version"][0] < stale["map_version"][1]
    assert r["listing"]["per_shard"]["shard-a"] >= 1
    assert r["restore"]["blocks"] == r["degraded"]["blocks"]
    d = r["degraded"]
    assert d["blocks_lost_data"] >= 1
    assert d["rebuilt_blocks"] == d["blocks_lost_data"]
    assert d["gf256_launches"] == 0  # the plain twin on the CPU
    assert r["config"]["config_failover_s"] > 0
    assert r["config"]["new_config_leader"] != r["config"]["killed"]["addr"]
    assert r["dataset_read"]["exact"]
    assert r["dataset_read"]["killed"]["shard"] == "shard-a"
    assert [k["leader"] for k in r["kills"]] == [True, True, True, False,
                                                  False]
    assert r["cut"] is not None and len(r["reduced"]) == 4
    assert any("split threshold 5" in d for d in r["departures"])
    assert any("scrubber every 3" in d for d in r["departures"])
    scrub = r["scrub"]
    assert scrub["path"] == "/z/scrub/probe.bin" and scrub["reports"] >= 1
    assert 0 < scrub["found_s"] <= 3 + 30
    assert list(tmp_path.iterdir()) == []  # the cluster's dirs are removed


async def test_a_dead_first_master_does_not_drain_the_retry_budget(tmp_path):
    """Queue 3's fault 3: a 3-master group whose first-listed master is
    down. Each call of the reference's client starts at the dead master,
    deposits its retry token there and spends its retry from the next
    master's bucket, which no first attempt refills: after its burst of
    10, every call fails at its first refusal. The port's client bans a
    refused master for every call (``REFUSED_TTL``), so each call starts
    at a live one: 30 metadata reads in a row all answer."""
    c = MiniCluster(tmp_path, n_masters=3, n_cs=1)
    await c.start()
    try:
        leader = await c.leader()
        await c.wait_out_of_safe_mode(leader)
        dead = next(a for a in c.masters if a != leader.address)
        addrs = [dead] + [a for a in c.masters if a != dead]
        port = Client(addrs, block_size=BLOCK)
        ref = RefClient(addrs, rpc_client=c.client, block_size=BLOCK)
        await port.create_file("/q3/f", b"fault three")
        await c.masters[dead].stop()
        await c.servers[dead].stop()
        del c.masters[dead]
        with pytest.raises(Exception) as ei:
            for _ in range(30):
                await ref.get_file_info("/q3/f")
        # The batched metadata fetch wraps the executor's
        # IndeterminateError in a DfsError.
        assert _names(ei.value)[:2] == ["DfsError", "Exception"]
        assert "IndeterminateError('BatchGetFileInfo: retry budget " \
            "exhausted after attempt 1" in str(ei.value)
        for _ in range(30):
            assert (await port.get_file_info("/q3/f"))["size"] == 11
        await port.close()
    finally:
        await c.stop()
