"""The port on the Helm chart's deployment (``deploy/helm/tpudfs``):

- the launcher against the chart: ``HelmCluster.plan()``'s flags for each
  kind of server held against the ``args`` the chart renders
  (``tpudfs.testing.minihelm``), every departure named here;
- one small deployment of processes (3 config servers, one shard of 3
  masters, one spare group of 3, 3 chunkservers, no TLS), shared by the
  tests below, with the masters' split threshold lowered to 5 requests a
  second and their split cooldown to 2 s (the chart: 100 and the masters'
  30 s), so that a split comes within seconds:
  - a checkpoint restored into the CPU device across a hot-prefix split,
    through the port's client and the reference's, each bit-exact, and
    through a long-lived client of each package whose map predates the
    split (each follows ``REDIRECT:``);
  - the config group's leader SIGKILLed and a follower stopped: a fresh
    client of each package given only the config servers (what each one
    does is pinned);
  - a checkpoint saved through the port's client while its shard leader's
    route is partitioned, and what each package's client answers then;
- the port's ``FaultProxy`` against the reference's on one upstream, and
  ``kill_plan(..., shards=)`` against the roulette's ``make_plan``.

Byte functions: no tolerance."""

from __future__ import annotations

import asyncio
import importlib.util
import os
import random
import re
import shlex
import signal
import time
from pathlib import Path

import pytest
import torch

from tpudfs.client.client import Client as RefClient
from tpudfs.common import resilience as ref_resilience
from tpudfs.testing.minihelm import render_objects
from tpudfs.testing.netem import FaultProxy as RefProxy
from tpudfs_torch import ckpt_chaos as cc
from tpudfs_torch.client.client import Client
from tpudfs_torch.cluster import (
    HELM,
    HelmCluster,
    find_config_leader_async,
    find_leader_async,
    wait_moved,
    wait_redirect,
)
from tpudfs_torch.gpu.checkpoint import CheckpointManager
from tpudfs_torch.gpu.hbm_reader import HbmReader
from tpudfs_torch.netem import FaultProxy

REPO = Path(__file__).resolve().parents[1]
CHART = REPO / "deploy" / "helm" / "tpudfs"
CPU = torch.device("cpu")
BLOCK = 64 * 1024
KIB = 160
#: The small deployment's split threshold and cooldown (see above).
SPLIT_RPS, SPLIT_COOLDOWN_S = 5.0, 2.0

# ------------------------------------------------- the launcher vs the chart

#: Flags whose values are addresses or paths: the chart's are pod DNS
#: names and volume mounts, the launcher's local ports and directories.
ADDRESS_FLAGS = {"--host", "--port", "--advertise", "--data-dir", "--peers",
                 "--config-servers"}
#: The launcher's departures from the chart's flags, each forced:
DEPARTURES = {
    # ops HTTP off: every server on one host would need a port each.
    ("config", "--http-port"), ("master", "--http-port"),
    ("spare", "--http-port"), ("chunkserver", "--http-port"),
    # each bootstrap shard names its 3 masters, which boot as one Raft
    # group: the chart's bare ids over spare singletons give each shard
    # three 1-voter groups.
    ("config", "--bootstrap-shards"), ("master", "--shard-id"),
    ("master", "--peers"), ("spare", "--peers"),
}


def _flags(words: list[str]) -> dict[str, str]:
    out, i = {}, 0
    while i < len(words):
        assert words[i].startswith("--"), words
        out[words[i]] = words[i + 1]
        i += 2
    return out


def _chart() -> dict:
    """Each kind of server as the chart renders it: module, flags,
    replicas and environment."""
    sets = {d["metadata"]["name"]: d
            for docs in render_objects(CHART).values() for d in docs
            if d["kind"] == "StatefulSet"}
    out = {}
    for kind, name in (("config", "tpudfs-config"),
                       ("master", "tpudfs-master"),
                       ("chunkserver", "tpudfs-cs")):
        sts = sets[name]
        c = sts["spec"]["template"]["spec"]["containers"][0]
        words = shlex.split(c["args"][0])
        assert words[:3] == ["exec", "python", "-m"], words
        out[kind] = {"module": words[3], "flags": _flags(words[4:]),
                     "replicas": sts["spec"]["replicas"],
                     "env": {e["name"]: e.get("value")
                             for e in c.get("env") or [] if "value" in e}}
    return out


def test_launcher_gives_each_server_the_charts_flags(tmp_path):
    chart = _chart()
    cluster = HelmCluster(tmp_path, tls=False)
    plan = cluster.plan()
    modules = {"config": "tpudfs.configserver", "master": "tpudfs.master",
               "spare": "tpudfs.master", "chunkserver": "tpudfs.chunkserver"}
    for kind, servers in plan.items():
        want = chart["master" if kind == "spare" else kind]
        assert want["module"] == modules[kind]
        for name, args in servers:
            got = _flags(args)
            for flag in set(want["flags"]) | set(got):
                if flag in ADDRESS_FLAGS or (kind, flag) in DEPARTURES:
                    continue
                assert flag in got and flag in want["flags"], (kind, flag)
                value, chart_value = got[flag], want["flags"][flag]
                if flag == "--rack-id":
                    # rack-$(( ordinal % 3 )) over the pod's ordinal.
                    mod = int(re.search(r"% (\d+)", chart_value).group(1))
                    ordinal = int(name.removeprefix("cs"))
                    assert value == f"rack-{ordinal % mod}", (name, value)
                elif re.fullmatch(r"[\d.]+", chart_value):
                    assert float(value) == float(chart_value), (kind, flag)
                else:
                    assert value == chart_value, (kind, flag)
            if "--config-servers" in want["flags"]:
                assert len(got["--config-servers"].split(",")) \
                    == len(want["flags"]["--config-servers"].split(",")) \
                    == chart["config"]["replicas"]
    # The departures' own values.
    shards = [sid for sid, _ in HELM["shards"]]
    for _, args in plan["config"]:
        boot = _flags(args)["--bootstrap-shards"]
        assert [e.split("=")[0] for e in boot.split(",")] == shards \
            == chart["config"]["flags"]["--bootstrap-shards"].split(",")
        assert all(len(e.split("=")[1].split("+")) == 3
                   for e in boot.split(","))
    assert chart["master"]["flags"]["--shard-id"] == ""
    assert [_flags(a)["--shard-id"] for _, a in plan["spare"]] == [""] * 3
    assert sorted({_flags(a)["--shard-id"] for _, a in plan["master"]}) \
        == sorted(shards)
    # Replica counts: the chart's master pool is shards x masters; the
    # spare group of 3 is the launcher's own.
    assert len(plan["config"]) == chart["config"]["replicas"] == 3
    assert len(plan["master"]) == chart["master"]["replicas"] == 6
    assert len(plan["spare"]) == 3
    assert len(plan["chunkserver"]) == chart["chunkserver"]["replicas"] == 5
    assert cluster.chunkserver_env == {
        "BLOCK_CACHE_SIZE": chart["chunkserver"]["env"]["BLOCK_CACHE_SIZE"]}
    assert HELM["split_threshold_rps"] == float(
        chart["master"]["flags"]["--split-threshold-rps"])


# ------------------------------------------------------ the small deployment


@pytest.fixture(scope="module")
def helm(tmp_path_factory):
    cluster = HelmCluster(tmp_path_factory.mktemp("helm"), tls=False,
                          shards=(("shard-a", 3),), chunkservers=3,
                          split_threshold_rps=SPLIT_RPS,
                          split_cooldown_s=SPLIT_COOLDOWN_S)
    with cluster:
        yield cluster


def _port(helm, **kw):
    return helm.client(block_size=BLOCK, max_retries=8, local_reads=False,
                       **kw)


def _ref(helm, **kw):
    return RefClient(config_addrs=list(helm.config_addrs), block_size=BLOCK,
                     max_retries=8, local_reads=False, **kw)


def _manager(client, base: str, *, ref: bool = False):
    kw = {"scopes": ref_resilience} if ref else {}
    return CheckpointManager(client, base, num_shards=1, ec=(2, 1),
                             reader=HbmReader(client, [CPU]), **kw)


async def _restore(mgr, step: int) -> None:
    cc.assert_restores_bit_exact(await mgr.restore(step, device=CPU), step,
                                 kib=KIB)


async def _save(client, base: str, step: int) -> None:
    await CheckpointManager(client, base, num_shards=1, ec=(2, 1)).save(
        step, {0: cc.ckpt_tree(step, 0, kib=KIB)})


async def test_restore_across_a_split_through_both_clients(helm):
    """``/a/`` is carved off to the spare group under 20 metadata calls a
    second: restores back to back through the port's client and the
    reference's meanwhile, each bit-exact; the new shard is the spare
    group, 3 voters; then a long-lived client of each package, its map
    from before the split, restores again and follows ``REDIRECT:``."""
    base = "/a/split-ckpt"
    writer, port, ref = _port(helm), _port(helm), _ref(helm)
    p2, r2, load = _port(helm), _ref(helm), _port(helm)
    stop = asyncio.Event()
    try:
        await _save(writer, base, 1)
        mine, theirs = _manager(port, base), _manager(ref, base, ref=True)
        await _restore(mine, 1)
        await _restore(theirs, 1)
        source = port.shard_map.get_shard(base + "/")
        v0 = (port.shard_map.version, ref.shard_map.version)
        paths = [p for p in await writer.list_files(base)]

        async def traffic():
            i = 0
            while not stop.is_set():
                try:
                    await load.get_file_info(paths[i % len(paths)])
                except Exception:
                    pass  # load, not a check
                i += 1
                await asyncio.sleep(0.05)

        task = asyncio.ensure_future(traffic())
        moved = asyncio.ensure_future(wait_moved(writer, base + "/", source,
                                                 60.0))
        across = 0
        while not moved.done():
            for mgr in (_manager(p2, base),
                        _manager(r2, base, ref=True)):
                await _restore(mgr, 1)
                across += 1
        await moved
        stop.set()
        await task
        target = writer.shard_map.get_shard(base + "/")
        peers = writer.shard_map.get_peers(target)
        assert target.startswith(f"{source}-split-") and across >= 2
        assert sorted(peers) == sorted(helm.spare_groups[0])
        leader = await find_leader_async(peers, client=writer)
        assert sorted((await writer.raft_state(leader))["config"]["voters"]) \
            == sorted(peers)
        await wait_redirect(writer, (await helm.refresh_shards())[source],
                            paths[0], target)
        assert (port.shard_map.version, ref.shard_map.version) == v0
        await _restore(mine, 1)
        await _restore(theirs, 1)
        assert port.redirects >= 1
        assert port.shard_map.get_shard(base + "/") == target
        assert ref.shard_map.get_shard(base + "/") == target
        assert ref.shard_map.version > v0[1]
    finally:
        stop.set()
        for c in (writer, port, ref, p2, r2, load):
            await c.close()


async def test_a_fresh_client_rides_a_config_election(helm):
    """Queue 3's fault 4. The config leader is SIGKILLed and one follower
    stopped, so the group cannot elect. A fresh client of each package
    given only the config servers: the reference's asks each config
    server once and raises ``no master addresses known``; the port's
    keeps asking, and once the follower resumes and the group elects, it
    answers and restores bit-exact. After the election a fresh reference
    client restores too."""
    base = "/c/ckpt"
    writer = _port(helm)
    try:
        await _save(writer, base, 1)
        path = (await writer.list_files(base))[0]
    finally:
        await writer.close()
    killed = await helm.kill_config(leader=True)
    assert killed is not None
    # Asked last, the stopped follower holds the reference's walk for its
    # 5 s timeout; the group has no quorum until it resumes.
    paused = helm.config_servers[next(
        n for n in sorted(helm.config_servers, reverse=True)
        if helm.config_servers[n].proc.poll() is None)]
    order = [a for a in helm.config_addrs if a != paused.addr] + [paused.addr]
    os.kill(paused.proc.pid, signal.SIGSTOP)
    ref = RefClient(config_addrs=order, block_size=BLOCK, local_reads=False)
    port = Client(config_addrs=order, block_size=BLOCK, local_reads=False)
    try:
        try:
            with pytest.raises(Exception) as ei:
                await ref.get_file_info(path)
            assert type(ei.value).__name__ == "DfsError"
            assert "no master addresses known" in str(ei.value)
            answer = asyncio.ensure_future(port.get_file_info(path))
            await asyncio.sleep(1.0)
            assert not answer.done()
        finally:
            os.kill(paused.proc.pid, signal.SIGCONT)
        t0 = time.monotonic()
        assert (await answer)["size"] > 0
        assert time.monotonic() - t0 < 15.0
        assert await find_config_leader_async(
            [a for a in helm.config_addrs if a != killed[1]], timeout=5.0)
        await _restore(_manager(port, base), 1)
        late = _ref(helm)
        try:
            await _restore(_manager(late, base, ref=True), 1)
        finally:
            await late.close()
    finally:
        await ref.close()
        await port.close()


async def test_a_save_through_a_partitioned_leader(helm):
    """The shard leader's route partitioned for 2 s through the port's
    ``FaultProxy`` while the port's client saves a checkpoint: the save
    publishes (resumed once if the partition failed it) and restores
    bit-exact. Beside it, a ``get_file_info`` through each package's
    client on the same partitioned route: both answer once it heals."""
    base = "/p/part-ckpt"
    plain = _port(helm)
    try:
        await _save(plain, base, 1)
        path = (await plain.list_files(base))[0]
        sid = plain.shard_map.get_shard(base + "/")
        leader = await find_leader_async(plain.shard_map.get_peers(sid),
                                         client=plain)
    finally:
        await plain.close()
    host, port_no = leader.rsplit(":", 1)
    proxy = FaultProxy(host, int(port_no))
    alias = {leader: await proxy.start()}
    port, ref = _port(helm, host_aliases=alias), _ref(helm, host_aliases=alias)
    try:
        mgr = _manager(port, base)
        save = asyncio.ensure_future(
            mgr.save(2, {0: cc.ckpt_tree(2, 0, kib=KIB)}))
        await asyncio.sleep(0.05)
        proxy.partition()
        reads = [asyncio.ensure_future(c.get_file_info(path))
                 for c in (port, ref)]
        await asyncio.sleep(2.0)
        assert not any(r.done() for r in reads)
        proxy.heal()
        for r in reads:
            assert (await r)["size"] > 0
        try:
            await save
        except Exception as e:
            assert cc.is_fault(e), e
            await cc.retry_until("the save", lambda: mgr.save(
                2, {0: cc.ckpt_tree(2, 0, kib=KIB)}), 30.0)
        assert await mgr.list_steps() == [1, 2]
        await _restore(mgr, 2)
    finally:
        await port.close()
        await ref.close()
        await proxy.stop()


# ------------------------------------------------------------- partitions


async def _echo_server():
    async def echo(reader, writer):
        try:
            while data := await reader.read(65536):
                writer.write(data)
                await writer.drain()
        except ConnectionError:
            pass
        writer.close()

    return await asyncio.start_server(echo, "127.0.0.1", 0)


async def _roundtrip(addr: str, payload: bytes = b"ping") -> bytes:
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        writer.write(payload)
        await writer.drain()
        return await asyncio.wait_for(reader.read(65536), 2.0)
    except (ConnectionError, asyncio.TimeoutError):
        return b""
    finally:
        writer.close()


async def test_fault_proxy_matches_the_reference():
    """Both packages' proxies on one echo server, toxic by toxic: the same
    bytes through, nothing through a partition (new connections and the
    established one), through again once healed, a latency held, an
    established connection severed."""
    server = await _echo_server()
    upstream = server.sockets[0].getsockname()
    seen = []
    for cls in (FaultProxy, RefProxy):
        proxy = cls(upstream[0], upstream[1])
        addr = await proxy.start()
        out = [await _roundtrip(addr)]
        host, port = addr.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        proxy.partition()
        out.append(await _roundtrip(addr))
        writer.write(b"held")
        try:
            await writer.drain()
            out.append(await asyncio.wait_for(reader.read(65536), 1.0))
        except (ConnectionError, asyncio.TimeoutError):
            out.append(b"")
        writer.close()
        proxy.heal()
        out.append(await _roundtrip(addr, b"healed"))
        proxy.set_latency(0.2)
        t0 = time.monotonic()
        out.append(await _roundtrip(addr, b"slow"))
        out.append(time.monotonic() - t0 >= 0.2)
        proxy.set_latency(0.0)
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(b"live")
        await writer.drain()
        out.append(await asyncio.wait_for(reader.read(65536), 2.0))
        proxy.sever()
        try:
            out.append(await asyncio.wait_for(reader.read(65536), 2.0))
        except (ConnectionError, asyncio.TimeoutError) as e:
            out.append(type(e).__name__)
        writer.close()
        await proxy.stop()
        seen.append(out)
    server.close()
    assert seen[0] == seen[1] == [b"ping", b"", b"", b"healed", b"slow",
                                  True, b"live", b""]


def _roulette():
    spec = importlib.util.spec_from_file_location(
        "chaos_roulette_for_port_test", REPO / "scripts" / "chaos_roulette.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kill_plan_draws_the_roulettes_plan():
    """For seeds 0-31 and the same endpoints (the chart's two 3-master
    shards, five chunkservers), ``kill_plan(..., shards=)`` draws
    ``make_plan``'s faults draw for draw, partitions included."""
    roulette = _roulette()
    shards = {"shard-z": ["m3", "m4", "m5"], "shard-a": ["m0", "m1", "m2"]}
    names = [f"cs{i}" for i in range(5)]
    eps = {"shards": shards,
           "procs": {n: {} for n in names + ["cfg", "shard-a-m0"]}}
    kinds = set()
    for seed in range(32):
        want = roulette.make_plan(random.Random(seed), eps)
        got = []
        for t, v in cc.kill_plan(random.Random(seed), names, shards=shards):
            if isinstance(v, cc.Partition):
                got.append((t, "partition", (v.shard, v.duration)))
            elif isinstance(v, cc.MasterKill):
                got.append((t, "kill_master", (v.shard, v.leader)))
            else:
                got.append((t, "kill_cs", v))
        assert got == want, seed
        kinds |= {k for _, k, _ in want}
    assert kinds == {"partition", "kill_cs", "kill_master"}


async def test_run_kill_plan_partitions_and_waits_out_each():
    plan = [(0.0, cc.Partition("shard-z", 0.2)), (0.05, "cs1")]
    seen = []

    async def partition(shard, duration):
        seen.append(("partition", shard))
        await asyncio.sleep(duration)
        seen.append(("healed", shard))
        return shard

    t0 = time.monotonic()
    done = await cc.run_kill_plan(plan, lambda v: seen.append(("cs", v)),
                                  partition=partition)
    assert time.monotonic() - t0 >= 0.2
    assert seen == [("partition", "shard-z"), ("healed", "shard-z"),
                    ("cs", "cs1")]
    assert done[0]["partitioned"] == "shard-z"
    with pytest.raises(ValueError, match="partition"):
        await cc.run_kill_plan(plan, lambda v: None)
