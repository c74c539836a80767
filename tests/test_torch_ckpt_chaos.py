"""The checkpoint stages of the fault tiers on the port
(``tpudfs_torch.ckpt_chaos``), held against the JAX package on the CPU:
the canonical trees bit for bit against ``tpudfs.testing.ckptchaos``; the
exploration gate's checkpoint scenario on the port's manager against the
reference's ``scenario_ckpt`` (same schedules and decision points at the
gate's budget), and the gate catching publish-before-durable rebuilt on
the port's ``commit``; then, on the reference ``MiniCluster`` with five
chunkservers, kill-mid-checkpoint, saves through a seeded kill plan with
their settle-and-verify, and the RS(3,2) rebuild after the data-shard
holders die. Restores land through an ``HbmReader`` on the CPU device, so
the kernels' plain twins run."""

import asyncio
import contextlib
import importlib.util
import inspect
import io
import json
import random
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_master_service import MiniCluster
from tpudfs.analysis.linearize import HistoryRecorder, check_history
from tpudfs.client.client import Client
from tpudfs.testing import ckptchaos as ref
from tpudfs.testing.vclock import InvariantViolation, explore, replay
from tpudfs_torch import ckpt_chaos as cc
from tpudfs_torch.common import ckptpaths
from tpudfs_torch.gpu import checkpoint as port_ckpt
from tpudfs_torch.gpu.hbm_reader import HbmReader

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


def _gate():
    spec = importlib.util.spec_from_file_location(
        "explore_gate_ref", REPO / "scripts" / "explore_gate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gate_budget() -> dict:
    """The checkpoint budget the gate runs at: ``BUDGETS["ckpt"]`` offset by
    the seed its command line defaults to (read from the gate's own
    ``main``, with its scenario runner replaced by a recorder)."""
    gate = _gate()
    seen = {}

    def record(name, *, seed, runs, bound):
        seen.update(seed=seed, runs=runs, bound=bound)
        return 0

    gate.run_scenario = record
    with contextlib.redirect_stdout(io.StringIO()):
        assert gate.main(["--scenario", "ckpt"]) == 0
    assert seen["runs"] is None and seen["bound"] is None
    bound, runs, seeds = gate.BUDGETS["ckpt"]
    return {"preemption_bound": bound, "max_runs": runs,
            "seeds": tuple(seen["seed"] + s for s in seeds)}


BUDGET = _gate_budget()


def _scenario():
    return cc.ckpt_scenario(HistoryRecorder, check_history,
                            InvariantViolation)


# ------------------------------------------------------------------ trees


@pytest.mark.parametrize("step,shard,kib", [(1, 0, 96), (3, 1, 96),
                                            (2, 1, 768), (7, 3, 5)])
def test_ckpt_tree_equals_reference(step, shard, kib):
    mine = cc.ckpt_tree(step, shard, kib=kib)
    want = ref.ckpt_tree(step, shard, kib=kib)
    assert sorted(mine) == sorted(want)
    for name in want:
        assert mine[name].dtype == want[name].dtype
        assert mine[name].tobytes() == want[name].tobytes()
    assert cc.trees_equal(mine, want) and ref.trees_equal(mine, want)
    assert cc.ckpt_tree(step, shard).keys() == ref.ckpt_tree(step, shard).keys()


def test_trees_equal_and_bit_exact_check():
    tree = cc.ckpt_tree(2, 0, kib=8)
    as_tensors = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    assert cc.trees_equal(as_tensors, tree)
    cc.assert_restores_bit_exact({0: as_tensors}, 2, kib=8)
    flipped = dict(tree, **{"opt/flags": tree["opt/flags"].copy()})
    flipped["opt/flags"][3] ^= 1
    assert not cc.trees_equal(flipped, tree)
    assert not cc.trees_equal({"layer0/w": tree["layer0/w"]}, tree)
    retyped = dict(tree, **{"opt/step_counts":
                            tree["opt/step_counts"].view(np.float32)})
    assert not cc.trees_equal(retyped, tree)
    with pytest.raises(AssertionError, match="step 2 shard 0"):
        cc.assert_restores_bit_exact({0: flipped}, 2, kib=8)
    from tpudfs_torch import bench
    assert bench.ckpt_tree is cc.ckpt_tree
    assert bench.trees_equal is cc.trees_equal


# ------------------------------------------------------- exploration gate


def test_ckpt_scenario_passes_gate_with_reference_counts():
    mine = explore(_scenario(), **BUDGET)
    want = explore(_gate().scenario_ckpt, **BUDGET)
    assert want.ok, want.failure and want.failure.describe()
    assert mine.ok, mine.failure.describe()
    assert (mine.runs, mine.decision_points) == \
        (want.runs, want.decision_points)
    assert mine.runs > BUDGET["max_runs"]  # the seeded walks ran too
    assert mine.schedules_ok == mine.runs


def test_mem_client_suspends_on_every_op_and_raises_port_errors():
    client = cc.MemDfsClient()

    async def run():
        for op in (client.create_file("/a", b"x"), client.get_file("/a"),
                   client.get_file_info("/a"),
                   client.list_files_with_meta("/"),
                   client.publish_checkpoint("/b", 1, "/a", "/m"),
                   client.delete_file("/a")):
            assert inspect.iscoroutine(op)
            task = asyncio.ensure_future(op)
            await asyncio.sleep(0)  # one turn: the op must not be done yet
            assert not task.done()
            await task
        with pytest.raises(cc.DfsError, match="not found"):
            await client.get_file("/a")
        await client.create_file("/c", b"y")
        with pytest.raises(cc.DfsError, match="exists"):
            await client.create_file("/c", b"z")
        with pytest.raises(cc.DfsError, match="missing"):
            await client.publish_checkpoint("/b", 2, "/nope", "/m2")
        assert await client.publish_checkpoint("/b", 1, "/c", "/m") is False

    asyncio.run(run())


def test_gate_catches_publish_before_durable_on_port_and_replays(monkeypatch):
    """Publish-before-durable rebuilt on the port's ``commit`` (the
    reference gate's ``mutate_publish_before_durable``): the manifest is
    published first, the shards verified after."""
    async def buggy_commit(self, step: int) -> dict:
        manifest = {
            "format": port_ckpt.FORMAT, "base": self.base, "step": step,
            "num_shards": self.num_shards,
            "ec": list(self.ec) if self.ec else None,
            "created_at_ms": int(time.time() * 1000), "shards": [],
        }
        body = json.dumps(manifest, sort_keys=True).encode()
        staged = ckptpaths.staged_manifest_path(self.base, step)
        await self.client.create_file(staged, body, overwrite=True)
        await self.client.publish_checkpoint(
            self.base, step, src=staged,
            dst=ckptpaths.manifest_path(self.base, step))
        manifest["shards"] = await self._verify_staged(step)
        self.stats["commits"] += 1
        return manifest

    monkeypatch.setattr(port_ckpt.CheckpointManager, "commit", buggy_commit)
    factory = _scenario()
    report = explore(factory, **BUDGET)
    assert not report.ok
    failure = report.failure
    assert failure.error_type == "InvariantViolation"
    assert "torn checkpoint visible" in failure.error
    again = replay(factory, json.loads(json.dumps(failure.trace)))
    assert not again.ok
    assert again.error == failure.error


# ---------------------------------------------------- against a MiniCluster


async def _cluster(tmp_path, n_cs=5) -> MiniCluster:
    c = MiniCluster(tmp_path, n_masters=1, n_cs=n_cs,
                    liveness_cutoff_ms=1500,
                    intervals={"liveness": 0.5, "healer": 3600,
                               "balancer": 3600, "tiering": 3600})
    await c.start()
    leader = await c.leader()
    await c.wait_out_of_safe_mode(leader)
    return c


def _client(c, block_size=16384) -> Client:
    return Client(list(c.masters), rpc_client=c.client,
                  block_size=block_size, rpc_timeout=3.0, max_retries=8,
                  local_reads=False)


async def _kill(c, i: int) -> None:
    await c.chunkservers[i].stop()
    c.heartbeats[i].stop()


async def _kill_and_drop(c, i: int) -> None:
    """Kill chunkserver ``i`` and wait until the master has dropped it."""
    await _kill(c, i)
    leader = await c.leader()
    addr = c.chunkservers[i].address
    for _ in range(100):
        if addr not in leader.state.chunk_servers:
            return
        await asyncio.sleep(0.1)
    raise AssertionError(f"the master never dropped {addr}")


async def test_kill_mid_checkpoint_on_minicluster(tmp_path):
    c = await _cluster(tmp_path)
    try:
        client = _client(c)

        async def kill_mid():
            for i in (1, 2):
                await _kill(c, i)

        out = await cc.kill_mid_checkpoint(
            client, lambda: _kill_and_drop(c, 0), kill_mid,
            base="/a/chaos-ckpt", kib=96, reader=HbmReader(client, [CPU]),
            device=CPU, resume_s=30.0)
        # The kills cut shard 1's put on the wire and tore the save.
        assert out["mid_save"] and out["interrupted"], out
        assert set(out["restore_s"]) == {1, 2}
        assert out["resume_s"] <= 30.0
        # The resume skipped only what had landed: shard 0 was never put
        # again, the torn shard 1 was.
        assert out["resume_puts"][0] == 0 and out["resume_puts"][1] >= 1, out
        assert out["shards_skipped"] >= 1, out
    finally:
        await c.stop()


async def test_saves_through_faults_then_settle_and_verify(tmp_path):
    c = await _cluster(tmp_path)
    try:
        client = _client(c)
        rng = random.Random(7)
        by_addr = {cs.address: i for i, cs in enumerate(c.chunkservers)}
        plan = cc.kill_plan(rng, by_addr, first=(0.1, 0.5), gap=(0.3, 0.8))
        assert 1 <= len(plan) <= 2 and len({v for _, v in plan}) == len(plan)
        mgr = cc.roulette_manager(client, reader=HbmReader(client, [CPU]))
        assert mgr.ec == (2, 1) and mgr.hot_copies and mgr.num_shards == 2
        killed = []

        async def kill(addr):
            killed.append(addr)
            await _kill(c, by_addr[addr])

        attempted, published = await cc.save_through_faults(
            mgr, steps=4, rng=rng, kib=96,
            faults=lambda: cc.run_kill_plan(plan, kill))
        assert attempted == 4
        # The plan starts once step 1 is acked, so the acked set the
        # settle checks is never empty, and has run whole on return.
        assert 1 in published
        assert killed == [v for _, v in plan]
        out = await cc.settle_and_verify(mgr, attempted, published, kib=96,
                                         device=CPU, settle_s=30.0)
        assert set(published) <= set(out["listed"])
        assert 4 in out["listed"]
        assert set(out["restore_s"]) == set(out["listed"])
    finally:
        await c.stop()


async def test_rebuild_after_data_shard_holders_die(tmp_path):
    c = await _cluster(tmp_path)
    try:
        client = _client(c)
        reader = HbmReader(client, [CPU])
        by_addr = {cs.address: i for i, cs in enumerate(c.chunkservers)}
        killed = []

        async def kill(victims):
            killed.extend(victims)
            for a in victims:
                await _kill(c, by_addr[a])

        out = await cc.rebuild_after_kills(client, kill, base="/a/ec-ckpt",
                                           kib=96, reader=reader, device=CPU)
        assert killed == out["victims"] and len(killed) == 2
        held = out["data_shards_held"]
        assert sorted(held[v] for v in killed) == sorted(held.values())[-2:]
        assert out["blocks_lost_data"] > 0
        # One decode a block that lost a data shard; no kernel on the CPU.
        assert out["rebuilt_blocks"] == out["blocks_lost_data"]
        assert out["gf256_launches"] == 0
    finally:
        await c.stop()


async def test_rebuild_raises_when_no_rebuild_ran(tmp_path):
    """A kill that takes nothing down (the callback kills no one): blocks
    lost a data shard on paper and none was rebuilt, so the stage refuses
    to pass."""
    c = await _cluster(tmp_path, n_cs=5)
    try:
        client = _client(c)
        with pytest.raises(AssertionError, match="and 0 were rebuilt"):
            await cc.rebuild_after_kills(
                client, lambda victims: None, base="/a/ec-live", kib=8,
                reader=HbmReader(client, [CPU]), device=CPU)
    finally:
        await c.stop()


def test_data_shard_holders_counts_only_data_indices():
    metas = [{"blocks": [
        {"ec_data_shards": 3, "locations": ["a", "b", "c", "d", "e"]},
        {"ec_data_shards": 3, "locations": ["b", "c", "d", "e", "a"]},
        {"locations": ["a", "b", "c"]},  # replicated: no data shards
    ]}]
    held = cc.data_shard_holders(metas)
    assert held == {"a": 1, "b": 2, "c": 2, "d": 1}


def test_kill_plan_is_seeded_and_survivable():
    names = [f"cs{i}" for i in range(5)]
    plans = [cc.kill_plan(random.Random(s), names) for s in range(40)]
    assert plans[3] == cc.kill_plan(random.Random(3), names)
    assert {len(p) for p in plans} == {1, 2}
    for p in plans:
        offsets = [t for t, _ in p]
        assert offsets == sorted(offsets) and 1.0 <= offsets[0] <= 3.0
        assert len({v for _, v in p}) == len(p)
