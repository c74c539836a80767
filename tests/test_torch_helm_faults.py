"""Three fault events on the Helm chart's deployment, through the port's
``Client`` (the config servers alone, no local short circuit) and
``CheckpointManager``, every restore into the CPU device through an
``HbmReader``, bit-exact:

- a config failover in the middle of a split
  (``helm_chaos.config_failover_mid_split``);
- a split held by a new leader's cooldown
  (``helm_chaos.split_in_cooldown``);
- a save that the chunkserver kills alone tear
  (``ckpt_chaos.kills_tear_checkpoint``).

One small deployment of processes serves them in this order: 3 config
servers, one shard of 3 masters, two spare groups of 3 (each split takes
one), 4 chunkservers, no TLS, the masters' split threshold lowered to 5
requests a second and their cooldown to 11 s, longer than two of their
5 s metric ticks, so that the cooldown, not the moving average's
warm-up, is what holds a new leader's split (the chart: 100 and the
masters' 30 s). Four chunkservers, not three: the chart's racks
(``rack-{i % 3}``) then leave two racks with one chunkserver each, which
every RS(2,1) placement includes, so killing one tears the put that
starts next and still leaves three chunkservers for its resume; on three
chunkservers no victim does both.

Byte functions: no tolerance."""

from __future__ import annotations

import functools

import pytest
import torch

from tpudfs_torch import ckpt_chaos as cc
from tpudfs_torch import helm_chaos as hc
from tpudfs_torch.cluster import HelmCluster
from tpudfs_torch.gpu.hbm_reader import HbmReader

CPU = torch.device("cpu")
BLOCK = 64 * 1024
KIB = 160
SPLIT_RPS, SPLIT_COOLDOWN_S, TRAFFIC_OPS = 5.0, 11.0, 20.0
#: The torn save's home: ``/a/`` after its split, a shard whose whole
#: range is the prefix, which never splits again. On ``shard-a`` the
#: save's own calls would heat ``/c/`` past the lowered threshold, and
#: with both spare groups taken that split freezes ``/c/`` for good
#: (ROADMAP.md, not the port's).
TORN_BASE = "/a/torn-ckpt"


@pytest.fixture(scope="module")
def helm(tmp_path_factory):
    cluster = HelmCluster(tmp_path_factory.mktemp("helm-faults"), tls=False,
                          shards=(("shard-a", 3),), chunkservers=4,
                          split_threshold_rps=SPLIT_RPS,
                          split_cooldown_s=SPLIT_COOLDOWN_S, spares=2)
    with cluster:
        yield cluster


def _factory(helm):
    return functools.partial(helm.client, block_size=BLOCK, max_retries=8,
                             local_reads=False)


def test_spare_groups_and_the_scrubber_in_the_plan(tmp_path):
    """``spares`` groups of 3, each one Raft group of its own; the chart's
    scrubber unless ``scrub_interval_s`` is given, which is a departure."""
    plan = HelmCluster(tmp_path, tls=False, spares=2).plan()
    spares = [args for _, args in plan["spare"]]
    assert len(spares) == 6
    for g in range(2):
        members = [a for a in spares[3 * g: 3 * g + 3]]
        ports = {a[a.index("--port") + 1] for a in members}
        for args in members:
            peers = args[args.index("--peers") + 1].split(",")
            assert len(peers) == 2
            assert {p.rsplit(":", 1)[1] for p in peers} < ports
    for _, args in plan["chunkserver"]:
        assert "--scrub-interval" not in args
    assert not any("scrub" in d for d in HelmCluster(tmp_path).departures)
    fast = HelmCluster(tmp_path, tls=False, scrub_interval_s=2.0)
    for _, args in fast.plan()["chunkserver"]:
        assert args[args.index("--scrub-interval") + 1] == "2.0"
    assert any("scrubber every 2.0 s" in d for d in fast.departures)
    assert any("spare groups of 3 masters (2)" in d for d in
               HelmCluster(tmp_path, spares=2).departures)
    assert HelmCluster(tmp_path).spares == 1 == len(
        HelmCluster(tmp_path, tls=False).plan()["spare"]) // 3


async def test_a_config_failover_mid_split(helm):
    """The split of ``/a/`` begins while the config group has no leader
    (leader and a follower stopped) and completes through a new config
    leader: ``/a/`` moves once, to a spare group of 3 voters; no spare
    group stays reserved for a shard the map lacks; a save started inside
    the freeze publishes without putting its landed shard again; a client
    whose map predates the split restores through ``REDIRECT:``."""
    r = await hc.config_failover_mid_split(
        helm, _factory(helm), prefix="/a/", kib=KIB, device=CPU,
        rate=TRAFFIC_OPS, cooldown_s=SPLIT_COOLDOWN_S, block_size=BLOCK)
    assert r["from"] == "shard-a" and r["to"].startswith("shard-a-split-")
    assert sorted(r["peers"]) in [sorted(g) for g in helm.spare_groups]
    assert len(r["voters"]) == 3
    assert sum(map(len, r["split_lines"].values())) == 1
    assert set(r["assigned"]) <= set(helm.shards)
    assert r["save"]["shard0_puts"] == 0
    assert r["stale_map_redirects"] >= 1
    assert r["config_failover_s"] > 0 and r["split_s"] > r["split_began_s"]
    assert r["frozen_s"] is not None and r["frozen_s"] > 0
    assert r["new_config_leader"] != next(
        c.addr for c in helm.config_servers.values()
        if c.name == r["config_killed"])
    assert all(g > 0 for g in r["restore_gbps"])


async def test_a_split_waits_out_a_new_leaders_cooldown(helm):
    """``/b/`` hot, its shard's leader SIGKILLed before any migration: the
    new leader splits ``/b/`` once, no earlier than its cooldown after its
    election, to the other spare group; the restores through the window
    are all bit-exact."""
    r = await hc.split_in_cooldown(
        helm, _factory(helm), prefix="/b/", kib=KIB, device=CPU,
        rate=TRAFFIC_OPS, cooldown_s=SPLIT_COOLDOWN_S, block_size=BLOCK)
    assert r["from"] == "shard-a" and r["to"].startswith("shard-a-split-")
    assert r["leader_to_split_s"] >= SPLIT_COOLDOWN_S
    assert r["kill_to_leader_s"] > 0
    assert list(r["split_lines"]) == [r["new_leader"]]
    assert r["new_leader"] != r["killed"]["name"]
    assert r["restores"] >= 2
    # /b/ went to a spare group no other split has taken.
    assert sorted(r["peers"]) in [sorted(g) for g in helm.spare_groups]
    assert not [sid for sid, peers in helm.shards.items()
                if sid != r["to"] and sorted(peers) == sorted(r["peers"])]


async def test_a_save_that_the_kills_alone_tear(helm):
    """A 2-shard checkpoint (hot 3x, RS(2,1) cold copy) at ``TORN_BASE``
    (after the split test: its shard cannot split again): the victim read
    from the save's own metadata holds a shard of every EC block landed;
    killed as shard 1's cold copy begins, it tears the save by itself
    (never cancelled); step 2 is unlisted until the resume, which skips
    shard 0 by its ETag; [1, 2] listed, both bit-exact."""
    by_addr = {cs.addr: cs for cs in helm.chunkservers}
    client = _factory(helm)()
    try:
        assert await client.refresh_shard_map()
        home = client.shard_map.get_shard(TORN_BASE + "/x")
        assert home.startswith("shard-a-split-"), (
            f"{TORN_BASE} lives on {home}: the torn save needs /a/ split off "
            "first (test_a_config_failover_mid_split, earlier in this file)")
        r = await cc.kills_tear_checkpoint(
            client, lambda victims: [by_addr[a].kill() for a in victims],
            list(by_addr), base=TORN_BASE, kib=KIB,
            reader=HbmReader(client, [CPU]), device=CPU, ec=(2, 1))
    finally:
        await client.close()
    assert r["interrupted"] and r["error"]
    assert r["listed_torn"] == [1]
    assert r["resume_puts"][0] == 0 and r["resume_puts"][1] >= 1
    assert r["shards_skipped"] >= 3  # shard 0's two copies, shard 1's hot
    assert set(r["restore_s"]) == {1, 2}
    assert by_addr[r["victim"]].proc.poll() is not None


def test_tearing_victim_reads_the_placement():
    """The victim holds a shard of every landed EC block and leaves every
    block a live copy and enough chunkservers for the resume; raises when
    none does (three chunkservers, RS(2,1) on all of them)."""
    hot = {"blocks": [{"locations": ["a", "b", "c"]},
                      {"locations": ["d", "b", "c"]}]}
    ec = {"blocks": [{"locations": ["a", "b", "c"], "ec_data_shards": 2},
                     {"locations": ["d", "b", "c"], "ec_data_shards": 2}]}
    four = "abcd"
    assert cc.tearing_victim({"/h": hot, "/e": ec}, (2, 1), four) == "b"
    three = {"blocks": [{"locations": ["a", "b", "c"], "ec_data_shards": 2}]}
    with pytest.raises(RuntimeError, match="no chunkserver tears"):
        cc.tearing_victim({"/e": three}, (2, 1), "abc")
    assert cc.tearing_victim({"/e": three}, (2, 1), four) == "a"
    lone = {"blocks": [{"locations": ["b"]}]}
    assert cc.tearing_victim({"/h": lone, "/e": ec}, (2, 1), four) == "c"

