"""Fault events that a hot-prefix split meets on the Helm chart's
deployment (:class:`~tpudfs_torch.cluster.HelmCluster`), driven through the
port's ``Client`` and ``CheckpointManager``:

- :func:`config_failover_mid_split`: the split of a hot prefix begins
  while the config group has no leader (its leader and one follower
  stopped), and completes through a new config leader; a save into the
  frozen range publishes once the split commits;
- :func:`split_in_cooldown`: the source shard's leader SIGKILLed while
  its prefix is hot and before any migration began; the new leader may
  split only one cooldown after it took over.

A split runs in the masters (``tpudfs/master/service.py``): the first
step, ``begin_migration``, is local to the source's Raft group and
freezes writes in the range; every later step asks the config group
(``FetchShardMap``, ``AllocateShardGroup``, ``CarveShard``). The events
read the servers' own log lines for what the wire does not show: a
master's ``became leader for term`` and ``hot prefix <p> (...): splitting
into <shard>``, whose timestamps are the host's wall clock.

Every checkpoint restore is checked bit-exact (:mod:`tpudfs_torch.ckpt_chaos`
trees) through an ``HbmReader`` on ``device``; on a card every full block
must launch ``crc32c_blocks``. The client factory comes from the caller
(``functools.partial(cluster.client, block_size=..., max_retries=8,
local_reads=False)``: the config servers alone, as the chart's users
build it). Restores' GB/s are the payload over the restore's wall time.
"""

from __future__ import annotations

import asyncio
import datetime
import logging
import os
import re
import signal
import statistics
import time

from tpudfs_torch.ckpt_chaos import (
    PutLog,
    _trees,
    restore_checked,
    retry_until,
)
from tpudfs_torch.cluster import (
    find_config_leader_async,
    find_leader_async,
    wait_moved,
    wait_redirect,
)
from tpudfs_torch.common import ckptpaths
from tpudfs_torch.gpu import resolve_device
from tpudfs_torch.gpu.checkpoint import CheckpointManager
from tpudfs_torch.gpu.hbm_reader import HbmReader

logger = logging.getLogger(__name__)

#: The masters' metric and split-detector tick (``METRICS_DECAY_INTERVAL``,
#: ``SPLIT_DETECTOR_INTERVAL``): a new leader's first cooldown check comes
#: within one.
TICK_S = 5.0
_STAMP = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) ")


def log_times(cluster, name: str, needle: str) -> list[float]:
    """Wall-clock times (epoch seconds) of the lines of server ``name``'s
    log that hold ``needle``, in order."""
    path = cluster.root / "logs" / f"{name}.log"
    out = []
    for line in path.read_text(errors="replace").splitlines():
        m = _STAMP.match(line)
        if m and needle in line:
            out.append(datetime.datetime.strptime(
                m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp())
    return out


def split_lines(cluster, prefix: str) -> dict[str, list[str]]:
    """Each master's log lines that begin a split of ``prefix``."""
    needle = f"hot prefix {prefix} ("
    out = {}
    for name in cluster.masters:
        path = cluster.root / "logs" / f"{name}.log"
        lines = [ln for ln in path.read_text(errors="replace").splitlines()
                 if needle in ln and "splitting into" in ln]
        if lines:
            out[name] = lines
    return out


def elected_at(cluster, name: str) -> float:
    """When master ``name`` last became its group's leader (wall clock)."""
    times = log_times(cluster, name, "became leader for term")
    if not times:
        raise RuntimeError(f"{name}'s log holds no election")
    return times[-1]


def _name_of(cluster, addr: str) -> str:
    return next(m.name for m in cluster.masters.values() if m.addr == addr)


async def first_config_answer(rpc, addrs, t_kill: float,
                             deadline_s: float) -> dict:
    """Poll ``addrs`` (config servers) with ``FetchShardMap`` (a
    linearizable read: only a leader answers it) until one answers; the
    seconds from ``t_kill`` (``time.perf_counter``) and who answered.
    Raises AssertionError once ``deadline_s`` seconds from ``t_kill`` pass
    with no answer."""
    while True:
        for addr in addrs:
            try:
                await rpc.call(addr, "ConfigService", "FetchShardMap", {},
                               timeout=1.0)
            except Exception:
                continue
            return {"config_failover_s": time.perf_counter() - t_kill,
                    "new_config_leader": addr}
        if time.perf_counter() - t_kill > deadline_s:
            raise AssertionError(f"no config leader among {list(addrs)} "
                                 f"{deadline_s} s after the kill")
        await asyncio.sleep(0.02)


async def prefix_traffic(op, rate: float, stop: asyncio.Event) -> dict:
    """``await op(i)`` for i = 0, 1, ... at ``rate`` calls a second until
    ``stop`` is set, each call a task of its own (at most 64 at a time):
    the polls of a restarting job's other ranks. A call the cluster fails
    is counted, not raised: this is load. Returns the calls sent,
    answered and failed, the last error and the seconds."""
    loop = asyncio.get_running_loop()
    gate = asyncio.Semaphore(64)
    out = {"sent": 0, "answered": 0, "failed": 0, "last_error": None}
    tasks: set = set()

    async def call(i: int) -> None:
        async with gate:
            try:
                await op(i)
                out["answered"] += 1
            except Exception as e:
                out["failed"] += 1
                out["last_error"] = f"{type(e).__name__}: {str(e)[:160]}"

    t0 = loop.time()
    while not stop.is_set():
        wait = t0 + out["sent"] / rate - loop.time()
        if wait > 0:
            try:
                await asyncio.wait_for(stop.wait(), wait)
                break
            except asyncio.TimeoutError:
                pass
        task = asyncio.ensure_future(call(out["sent"]))
        tasks.add(task)
        task.add_done_callback(tasks.discard)
        out["sent"] += 1
    seconds = loop.time() - t0
    await asyncio.gather(*tasks)
    return {**out, "seconds": seconds, "ops_per_s": out["sent"] / seconds}


def file_info_op(client, paths: list[str]):
    """The op of :func:`prefix_traffic` that asks ``get_file_info`` of
    ``paths`` in turn."""
    return lambda i: client.get_file_info(paths[i % len(paths)])


async def write_probe(client, path: str, stop: asyncio.Event,
                      every: float = 0.2) -> dict:
    """A one-byte ``create_file`` of ``path`` every ``every`` seconds until
    ``stop`` is set, or until one succeeds after a failure: how long the
    range was closed to writes (``frozen_s``: the first failure to the
    first success after it) and the first failure's text."""
    first_fail = first_ok_after = error = None
    probes = failed = 0
    while not stop.is_set():
        t = time.perf_counter()
        probes += 1
        try:
            await client.create_file(path, b"p", overwrite=True)
            if first_fail is not None:
                first_ok_after = time.perf_counter()
                break
        except Exception as e:
            failed += 1
            if first_fail is None:
                first_fail, error = t, f"{type(e).__name__}: {str(e)[:200]}"
        await asyncio.sleep(every)
    return {"probes": probes, "failed": failed, "first_error": error,
            "frozen_s": None if first_ok_after is None
            else first_ok_after - first_fail}


async def _new_shard(cluster, client, path: str, source: str) -> dict:
    """The shard the map gives ``path`` after its prefix split off
    ``source``: its peers (a spare group) and its leader's voters (all
    3). (The prefix itself is the carved range's exclusive lower bound:
    ask for a path inside it.)"""
    await cluster.refresh_shards(client)
    target = cluster.shard_map.get_shard(path)
    peers = cluster.shards[target]
    leader = await find_leader_async(peers, client=client)
    voters = [] if leader is None else \
        (await client.raft_state(leader))["config"]["voters"]
    if not target.startswith(f"{source}-split-") or len(voters) != 3 \
            or sorted(voters) != sorted(peers) \
            or sorted(peers) not in [sorted(g) for g in cluster.spare_groups]:
        raise AssertionError(f"{path} split to {target}: peers {peers}, "
                             f"voters {voters}")
    return {"to": target, "peers": peers, "voters": sorted(voters)}


async def _cooldown_spent(cluster, name: str, cooldown_s: float) -> float:
    """Sleep until master ``name``'s split cooldown, which its first
    check as leader started, is spent; the seconds slept."""
    wait = elected_at(cluster, name) + cooldown_s + TICK_S + 0.5 \
        - time.time()
    if wait > 0:
        await asyncio.sleep(wait)
    return max(wait, 0.0)


async def config_failover_mid_split(cluster, factory, *, prefix: str,
                                    kib: int, device=None, rate: float,
                                    cooldown_s: float, block_size: int,
                                    wait_s: float = 90.0,
                                    resume_s: float = 120.0) -> dict:
    """A config failover in the middle of a split.

    A 2-shard hot-only checkpoint at ``prefix + "ckpt"`` saves step 1 and
    step 2's shard 0 (landed). Once the source shard's leader has spent
    its split cooldown, the config group's leader and one follower are
    ``SIGSTOP``-ped, so the group has no leader, and ``rate`` metadata
    calls a second start on ``prefix`` with a one-byte write probe beside
    them. When the source leader's log says it is splitting ``prefix``
    (its ``begin_migration``, which freezes the range, needs no config
    server), the traffic stops, a save of step 2 starts into the frozen
    range, the stopped leader is SIGKILLed and the follower resumed: the
    group elects and the split completes through the new config leader.
    (Traffic kept on until the hand-over leaves the source's moving
    average of the moved prefix over the threshold for ticks after it:
    with a cooldown that short the source begins a second split of the
    same prefix, which never ends; ROADMAP.md, not the port's.)

    Raises unless: the range moved exactly once (one ``splitting into``
    line), to a spare group of 3 voters; no master is assigned to a shard
    absent from the map (``ListMasters`` on the new config leader: no
    reservation leaked); the save published (resumed until it did)
    without putting shard 0's payload again; a client whose map predates
    the split restores step 2 through a ``REDIRECT:``; every restore is
    bit-exact. Returns ``split_s`` (traffic start to the moved map),
    ``config_failover_s`` (the kill to the first ``FetchShardMap`` a new
    leader answers), ``frozen_s`` (the probe's closed window), the
    restores and the traffic."""
    device = resolve_device(device)
    base = prefix + "ckpt"
    writer, stale, load, probe_client, watch = (
        factory(), factory(), factory(), factory(max_retries=3),
        factory(max_retries=2))
    clients = [writer, stale, load, probe_client, watch]
    stopped: list = []
    stop, heat = asyncio.Event(), asyncio.Event()
    try:
        log = PutLog(writer)
        mgr = CheckpointManager(log, base, num_shards=2, ec=None,
                                reader=HbmReader(writer, [device]))
        trees = {s: _trees(s, kib) for s in (1, 2)}
        await mgr.save(1, trees[1])
        await mgr.save_shard(2, 0, trees[2][0])
        payload0 = ckptpaths.shard_data_path(base, 2, 0)
        # The long-lived client's map, from before the split.
        smgr = CheckpointManager(stale, base, num_shards=2, ec=None,
                                 reader=HbmReader(stale, [device]))
        if await smgr.list_steps() != [1]:
            raise AssertionError("step 1 is not listed")
        await cluster.refresh_shards(watch)
        source = cluster.shard_map.get_shard(base + "/")
        v_before = cluster.shard_map.version
        leader = await find_leader_async(cluster.shards[source], client=watch)
        if leader is None:
            raise AssertionError(f"{source} has no leader")
        leader_name = _name_of(cluster, leader)
        if split_lines(cluster, prefix):
            raise AssertionError(f"{prefix} split before the event")
        for c in clients:
            # Each client's map before the config group loses its leader.
            if not await c.refresh_shard_map():
                raise AssertionError("no config server answered")
        cooled_s = await _cooldown_spent(cluster, leader_name, cooldown_s)

        cfg_leader = await find_config_leader_async(
            cluster.config_addrs, tls=cluster.client_tls)
        if cfg_leader is None:
            raise AssertionError("no config leader")
        victim = next(c for c in cluster.config_servers.values()
                      if c.addr == cfg_leader)
        follower = next(c for c in cluster.config_servers.values()
                        if c.addr != cfg_leader and c.proc.poll() is None)
        for c in (victim, follower):
            os.kill(c.proc.pid, signal.SIGSTOP)
            stopped.append(c)
        t0 = time.perf_counter()
        paths = [ckptpaths.shard_data_path(base, 1, s) for s in (0, 1)]
        traffic = asyncio.ensure_future(
            prefix_traffic(file_info_op(load, paths), rate, heat))
        probe = asyncio.ensure_future(
            write_probe(probe_client, prefix + "freeze-probe", stop))
        while not split_lines(cluster, prefix):
            if time.perf_counter() - t0 > wait_s:
                raise AssertionError(f"{prefix} did not begin to split in "
                                     f"{wait_s} s of {rate} calls a second")
            await asyncio.sleep(0.1)
        began_s = time.perf_counter() - t0
        heat.set()
        logger.info("%s began to split %.2f s into the traffic", prefix,
                    began_s)
        # A save that starts inside the freeze.
        save = asyncio.ensure_future(mgr.save(2, trees[2]))
        puts_before = len(log.calls)
        victim.kill()
        os.kill(follower.proc.pid, signal.SIGCONT)
        stopped.clear()
        t_kill = time.perf_counter()
        failover = await first_config_answer(
            watch.rpc, [c.addr for c in cluster.config_servers.values()
                        if c is not victim], t_kill, wait_s)
        logger.info("config leader %s after %.2f s",
                    failover["new_config_leader"],
                    failover["config_failover_s"])
        await wait_moved(watch, base + "/", source, wait_s)
        split_s = time.perf_counter() - t0
        logger.info("%s moved %.2f s into the traffic", prefix, split_s)
        try:
            await save
            published = "first try"
        except Exception as e:
            published = f"resumed after {type(e).__name__}: {str(e)[:160]}"
            await retry_until("the frozen save", lambda: mgr.save(2, trees[2]),
                              resume_s)
        logger.info("the frozen save published (%s)", published)
        stop.set()
        traffic_out, probe_out = await traffic, await probe
        resume_puts = log.calls[puts_before:].count(payload0)
        if resume_puts:
            raise AssertionError(f"the save put shard 0 again "
                                 f"({resume_puts}x) though it had landed")
        if await mgr.list_steps() != [1, 2]:
            raise AssertionError(f"listed {await mgr.list_steps()}")
        lines = split_lines(cluster, prefix)
        moved = await _new_shard(cluster, watch, base + "/", source)
        if sum(map(len, lines.values())) != 1 or \
                moved["to"] not in next(iter(lines.values()))[0]:
            raise AssertionError(f"{prefix} split more than once: {lines}")
        shard_ids = set(cluster.shard_map.get_all_shards())
        registry = (await watch.rpc.call(
            failover["new_config_leader"], "ConfigService", "ListMasters",
            {}))["masters"]
        leaked = {a: i["shard_id"] for a, i in registry.items()
                  if i.get("shard_id") and i["shard_id"] not in shard_ids}
        if leaked:
            raise AssertionError(f"reservations leaked: {leaked}")
        handoff_s = await wait_redirect(watch, cluster.shards[source],
                                        paths[0], moved["to"])
        redirects = stale.redirects
        restores = [await restore_checked(smgr, 2, kib, device, block_size)]
        if stale.redirects == redirects:
            raise AssertionError("the restore through the old map followed "
                                 "no redirect")
        restores.append(await restore_checked(
            CheckpointManager(watch, base, num_shards=2, ec=None,
                              reader=HbmReader(watch, [device])),
            1, kib, device, block_size))
    finally:
        stop.set()
        heat.set()
        for c in stopped:
            os.kill(c.proc.pid, signal.SIGCONT)
        for c in clients:
            await c.close()
    return {"prefix": prefix, "from": source, **moved,
            "map_version": [v_before, cluster.shard_map.version],
            "source_leader": leader_name, "cooldown_wait_s": cooled_s,
            "config_stopped": [victim.name, follower.name],
            "config_killed": victim.name, "split_began_s": began_s,
            "split_s": split_s, **failover, "handoff_s": handoff_s,
            "frozen_s": probe_out["frozen_s"], "probe": probe_out,
            "save": {"published": published, "shard0_puts": resume_puts,
                     "stats": dict(mgr.stats)},
            "assigned": sorted({i["shard_id"] for i in registry.values()
                                if i.get("shard_id")}),
            "stale_map_redirects": stale.redirects - redirects,
            "restores": restores,
            "restore_gbps": [r["gbps"] for r in restores],
            "traffic": traffic_out, "split_lines": lines}


async def split_in_cooldown(cluster, factory, *, prefix: str, kib: int,
                            device=None, rate: float, cooldown_s: float,
                            block_size: int, wait_s: float = 90.0) -> dict:
    """A split within a new leader's cooldown.

    A 2-shard hot-only checkpoint at ``prefix + "ckpt"`` saves step 1;
    ``rate`` metadata calls a second start on ``prefix`` and, before any
    migration has begun, the source shard's leader is SIGKILLed. Step 1
    is restored back to back until the new leader begins the split; the
    traffic and the restores stop there (see
    :func:`config_failover_mid_split` on a second split), and step 1 is
    restored once more after the map moved ``prefix`` off the shard.
    The new leader's monitor starts its cooldown at its first check as
    leader: raises unless its ``splitting into`` line comes at
    least ``cooldown_s`` after its ``became leader`` line, the split is
    the only one of ``prefix`` (none in the killed leader's log), the
    range went to a spare group of 3 voters, and every restore is
    bit-exact. Returns ``kill_to_leader_s`` (the kill to the new
    leader's election), ``leader_to_split_s`` (the election to the
    split's first line), ``split_s`` (the kill to the moved map), and the
    restores: how many, their median GB/s and ``[min, max]``, their
    kernel launches and full blocks."""
    device = resolve_device(device)
    base = prefix + "ckpt"
    writer, load, restorer, watch = (factory(), factory(), factory(),
                                     factory(max_retries=2))
    stop = asyncio.Event()
    try:
        mgr = CheckpointManager(writer, base, num_shards=2, ec=None)
        await mgr.save(1, _trees(1, kib))
        await cluster.refresh_shards(watch)
        source = cluster.shard_map.get_shard(base + "/")
        paths = [ckptpaths.shard_data_path(base, 1, s) for s in (0, 1)]
        traffic = asyncio.ensure_future(
            prefix_traffic(file_info_op(load, paths), rate, stop))
        await asyncio.sleep(0.2)
        if split_lines(cluster, prefix):
            raise AssertionError(f"{prefix} began to split before the kill")
        killed = await cluster.kill_master(source, leader=True, client=watch)
        t_kill = time.time()
        if killed is None:
            raise AssertionError(f"{source} had no leader to kill")
        survivors = [a for a in cluster.shards[source] if a != killed[1]]
        rmgr = CheckpointManager(restorer, base, num_shards=2, ec=None,
                                 reader=HbmReader(restorer, [device]))
        t0, restores = time.perf_counter(), []
        while not split_lines(cluster, prefix):
            if time.perf_counter() - t0 > cooldown_s + wait_s:
                raise AssertionError(f"{prefix} did not split in "
                                     f"{cooldown_s + wait_s} s after the "
                                     f"kill")
            restores.append(await restore_checked(rmgr, 1, kib, device,
                                                  block_size))
        stop.set()
        await wait_moved(watch, base + "/", source, wait_s)
        split_s = time.perf_counter() - t0
        traffic_out = await traffic
        restores.append(await restore_checked(rmgr, 1, kib, device,
                                              block_size))
        leader = await find_leader_async(survivors, client=watch)
        if leader is None:
            raise AssertionError(f"{source} elected no new leader")
        new_name = _name_of(cluster, leader)
        elected = elected_at(cluster, new_name)
        lines = split_lines(cluster, prefix)
        if list(lines) != [new_name] or len(lines[new_name]) != 1:
            raise AssertionError(f"{prefix} split by {lines}, not once by "
                                 f"the new leader {new_name}")
        began = log_times(cluster, new_name, f"hot prefix {prefix} (")[0]
        if elected < t_kill - 1.0 or began - elected < cooldown_s:
            raise AssertionError(
                f"{new_name} elected {elected - t_kill:+.2f} s after the "
                f"kill split {began - elected:.2f} s later, within its "
                f"{cooldown_s} s cooldown")
        target = await _new_shard(cluster, watch, base + "/", source)
        gbps = [r["gbps"] for r in restores]
    finally:
        stop.set()
        for c in (writer, load, restorer, watch):
            await c.close()
    return {"prefix": prefix, "from": source, **target,
            "killed": {"name": killed[0], "addr": killed[1],
                       "leader": True, "shard": source},
            "new_leader": new_name, "cooldown_s": cooldown_s,
            "kill_to_leader_s": elected - t_kill,
            "leader_to_split_s": began - elected, "split_s": split_s,
            "restores": len(restores),
            "restore_gbps": statistics.median(gbps),
            "restore_gbps_win": [min(gbps), max(gbps)],
            "restore_launches": {k: sum(r["launches"][k] for r in restores)
                                 for k in restores[0]["launches"]},
            "full_blocks": sum(r["full_blocks"] for r in restores),
            "traffic": traffic_out, "split_lines": lines}
