"""Port parity for sharded checkpoints: ``tpudfs_torch.gpu.checkpoint``
against the JAX package's ``tpudfs.tpu.checkpoint``, bit-exact (payloads
and CRCs are byte functions: no tolerance). The payload format and the
namespace layout byte for byte; on the reference ``MiniCluster`` the
reference manager saves and the port restores (host arrays, and tensors on
the CPU device through the port's ``HbmReader``: healthy, through the EC
cold copy with two chunkservers dead, and through the hot → EC fallback);
the port's own save (resume, torn checkpoints, idempotent and monotonic
publish, prune and GC under the reference's resilience scopes), which the
reference manager then restores; and the device restore of every payload
dtype on the port's ``LocalClient``."""

import asyncio

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_master_service import MiniCluster
from tpudfs.client.client import Client
from tpudfs.client.client import DfsError as RefDfsError
from tpudfs.common import ckptpaths as ref_paths
from tpudfs.common import resilience
from tpudfs.testing.ckptchaos import assert_restores_bit_exact, ckpt_tree
from tpudfs.tpu import checkpoint as ref
from tpudfs_torch.client.local import ChecksumMismatchError, LocalClient
from tpudfs_torch.common import ckptpaths
from tpudfs_torch.common.checksum import crc32c
from tpudfs_torch.gpu import checkpoint as port
from tpudfs_torch.gpu.hbm_reader import HbmReader

CPU = torch.device("cpu")


def _tree(seed: int) -> dict:
    """Every payload dtype of the port's map, odd sizes included."""
    rng = np.random.default_rng(seed)
    return {
        "w/f4": rng.standard_normal(1000, dtype=np.float32).reshape(10, 100),
        "w/f2": rng.standard_normal(333).astype(np.float16),
        "w/f8": rng.standard_normal(77),
        "opt/i4": rng.integers(-2**31, 2**31 - 1, 513, dtype=np.int32),
        "opt/u4": rng.integers(0, 2**32 - 1, 129, dtype=np.uint32),
        "opt/i8": np.asarray(rng.integers(0, 2**62), dtype=np.int64),
        "opt/u8": rng.integers(0, 2**63, 5, dtype=np.uint64),
        "opt/i2": rng.integers(-2**15, 2**15 - 1, 9, dtype=np.int16),
        "opt/u2": rng.integers(0, 2**16 - 1, 1025, dtype=np.uint16),
        "flags/i1": rng.integers(-128, 127, 31, dtype=np.int8),
        "flags/u1": rng.integers(0, 255, 3, dtype=np.uint8),
        "flags/b1": rng.integers(0, 2, 17).astype(bool),
        "empty": np.zeros((0, 4), dtype=np.float32),
    }


def _as_numpy(tree: dict) -> dict:
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


def _assert_tree_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = np.asarray(got[name])
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


# ------------------------------------------------------------- pure format


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_shard_matches_reference(seed):
    trees = [_tree(seed), ckpt_tree(seed + 1, seed)]
    for tree in trees:
        payload, specs = port.pack_shard(tree)
        ref_payload, ref_specs = ref.pack_shard(tree)
        assert payload == ref_payload
        assert [s.to_dict() for s in specs] == [s.to_dict() for s in ref_specs]
        assert all(s.offset % 512 == 0 for s in specs)
        # torch tensors pack to the same bytes as their numpy arrays.
        as_torch = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
        assert port.pack_shard(as_torch)[0] == payload
        # Each unpacks the other's payload.
        dicts = [s.to_dict() for s in specs]
        _assert_tree_equal(port.unpack_shard(ref_payload, dicts), tree)
        _assert_tree_equal(ref.unpack_shard(payload, dicts), tree)


def test_unpack_detects_torn_payload():
    payload, specs = port.pack_shard({"w": np.arange(1024, dtype=np.int32)})
    torn = bytearray(payload)
    torn[100] ^= 0xFF
    with pytest.raises(ChecksumMismatchError):
        port.unpack_shard(bytes(torn), [s.to_dict() for s in specs])
    with pytest.raises(ChecksumMismatchError):  # short payload
        port.unpack_shard(payload[:-1], [s.to_dict() for s in specs])


def test_ckptpaths_same_as_reference():
    for name in ("MANIFEST_PREFIX", "STEP_DIR"):
        assert getattr(ckptpaths, name) == getattr(ref_paths, name)
    for base in ("/ckpt/run1", "/ckpt/run1/", "/a"):
        for step in (0, 7, 10**15):
            for fn in ("manifest_path", "step_prefix", "staged_manifest_path"):
                assert getattr(ckptpaths, fn)(base, step) == \
                    getattr(ref_paths, fn)(base, step)
            for fn in ("shard_data_path", "shard_ec_path", "shard_spec_path"):
                assert getattr(ckptpaths, fn)(base, step, 3) == \
                    getattr(ref_paths, fn)(base, step, 3)
        assert ckptpaths.staging_root(base) == ref_paths.staging_root(base)
        assert ckptpaths.manifest_list_prefix(base) == \
            ref_paths.manifest_list_prefix(base)
    for path in ("/ckpt/run1/MANIFEST-0000000000000007",
                 "/ckpt/run1/MANIFEST-xyz", "MANIFEST-0000000000000007",
                 "/ckpt/run1/.ckpt/0000000000000007/shard-00002.bin",
                 "/user/data/file.bin", "/a/.ckpt/notdigits/x",
                 "/a/.ckpt/0000000000000007/", ".ckpt/0000000000000001/x"):
        assert ckptpaths.parse_manifest_path(path) == \
            ref_paths.parse_manifest_path(path)
        assert ckptpaths.parse_step_path(path) == \
            ref_paths.parse_step_path(path)


def test_manifest_validation_matches_reference():
    good = {"format": port.FORMAT, "base": "/b", "step": 1, "num_shards": 1,
            "shards": [{}]}
    import json

    assert port._validate_manifest(json.dumps(good).encode()) == \
        ref._validate_manifest(json.dumps(good).encode())
    bad = [{**good, "format": "x"}, {k: v for k, v in good.items()
                                      if k != "base"},
           {**good, "num_shards": 2}]
    for body in bad:
        with pytest.raises(port.CheckpointError):
            port._validate_manifest(json.dumps(body).encode())
        with pytest.raises(ref.CheckpointError):
            ref._validate_manifest(json.dumps(body).encode())


def test_unknown_dtype_raises():
    with pytest.raises(ValueError, match="no torch dtype"):
        port.torch_dtype(">f4")
    for s in ("<f4", "<i4", "<u4", "|i1", "|u1", "<i8", "<f8", "<f2"):
        assert port.torch_dtype(s).itemsize == np.dtype(s).itemsize


# --------------------------------------------- device restore, LocalClient


async def test_device_restore_every_dtype_on_local_client(tmp_path):
    """Every dtype through ``restore_shard_device`` on the port's
    ``LocalClient``: 4-byte tensors are views of one word stream, the rest
    bounce through the host; the same tree as ``unpack_shard``."""
    tree = _tree(5)
    payload, specs = port.pack_shard(tree)
    stores, metas = chip_smoke.lay_out_shard(
        tmp_path, np.frombuffer(payload, dtype=np.uint8), block_size=4096,
        hot="/c/hot", cold="/c/ec")
    client = LocalClient(stores, metas)
    spec = {"shard": 0, "path": "/c/hot", "ec_path": "/c/ec",
            "size": len(payload), "crc32c": crc32c(payload),
            "tensors": [s.to_dict() for s in specs]}
    stats = {"degraded_shard_reads": 0}
    stage = {}
    out = await port.restore_shard_device(HbmReader(client, [CPU]), client,
                                          spec, CPU, stats, stage_s=stage)
    _assert_tree_equal(_as_numpy(out), tree)
    assert set(stage) == {"read", "combined_crc", "assemble", "bounce"}
    words = {out[n].untyped_storage().data_ptr()
             for n in ("w/f4", "opt/i4", "opt/u4")}
    assert len(words) == 1
    assert out["w/f4"].dtype == torch.float32 and out["opt/u4"].dtype == \
        torch.uint32 and out["flags/b1"].dtype == torch.bool
    # A manifest CRC that disagrees with the blocks' fails both copies.
    with pytest.raises(port.DegradedRestoreError):
        await port.restore_shard_device(
            HbmReader(client, [CPU]), client, {**spec, "crc32c": 1}, CPU,
            stats)
    assert stats["degraded_shard_reads"] == 1


async def test_device_restore_rejects_unaligned_blocks(tmp_path):
    payload, specs = port.pack_shard({"w": np.arange(3000, dtype=np.float32)})
    stores, metas = chip_smoke.lay_out_shard(
        tmp_path, np.frombuffer(payload, dtype=np.uint8), block_size=1000,
        hot="/c/hot", cold="/c/ec")
    client = LocalClient(stores, metas)
    spec = {"shard": 0, "path": "/c/hot", "ec_path": None,
            "size": len(payload), "crc32c": crc32c(payload),
            "tensors": [s.to_dict() for s in specs]}
    with pytest.raises(ValueError, match="multiples of 512"):
        await port.restore_shard_device(HbmReader(client, [CPU]), client,
                                        spec, CPU, {"degraded_shard_reads": 0})


def test_device_without_reader_raises():
    mgr = port.CheckpointManager(LocalClient({}, {}), "/b", num_shards=1)
    with pytest.raises(ValueError, match="needs a reader"):
        asyncio.run(mgr.restore(1, device=CPU))
    with pytest.raises(ValueError, match="needs a reader"):
        asyncio.run(mgr.restore_shard({"step": 1, "shards": []}, 0,
                                      device=CPU))


# --------------------------------------------------------------- clusters


async def _ready(tmp_path, n_cs=3, block_size=64 * 1024):
    c = MiniCluster(tmp_path, n_masters=1, n_cs=n_cs)
    await c.start()
    leader = await c.leader()
    await c.wait_out_of_safe_mode(leader)
    client = Client(list(c.masters), rpc_client=c.client,
                    block_size=block_size)
    return c, client


def _port_mgr(client, base, **kw):
    return port.CheckpointManager(client, base, scopes=resilience,
                                  reader=HbmReader(client, [CPU]), **kw)


async def _port_restores_both_ways(mgr, step: int, shards: int) -> None:
    """Host arrays and CPU-device tensors, both bit-exact."""
    assert_restores_bit_exact(await mgr.restore(step), step)
    dev = await mgr.restore(step, device=CPU)
    assert sorted(dev) == list(range(shards))
    for tree in dev.values():
        assert all(isinstance(v, torch.Tensor) and v.device == CPU
                   for v in tree.values())
    assert_restores_bit_exact({s: _as_numpy(t) for s, t in dev.items()},
                              step)


async def test_reference_saves_port_restores_host_and_device(tmp_path):
    c, client = await _ready(tmp_path)
    try:
        saver = ref.CheckpointManager(client, "/ckpt/run1", num_shards=2,
                                      ec=(2, 1))
        manifest = await saver.save(1, {s: ckpt_tree(1, s) for s in range(2)})
        mgr = _port_mgr(client, "/ckpt/run1", num_shards=2, ec=(2, 1))
        assert await mgr.list_steps() == [1]
        assert await mgr.latest_step() == 1
        assert await mgr.read_manifest() == manifest
        await _port_restores_both_ways(mgr, 1, 2)
        assert mgr.stats["restored_shards"] == 4
        assert mgr.stats["degraded_shard_reads"] == 0
        # The port's host restore equals the reference's, array for array.
        want = await saver.restore(1)
        got = await mgr.restore(1)
        for s in range(2):
            _assert_tree_equal(got[s], want[s])
        with pytest.raises(port.CheckpointNotFoundError):
            await mgr.read_manifest(2)
        with pytest.raises(port.CheckpointNotFoundError):
            await mgr.restore_shard(manifest, 5)
    finally:
        await c.stop()


async def test_port_restores_with_two_chunkservers_dead_via_ec(tmp_path):
    c, client = await _ready(tmp_path, n_cs=5)
    try:
        base = "/ckpt/degraded"
        await ref.CheckpointManager(client, base, num_shards=2, ec=(3, 2),
                                    hot_copies=False).save(
            1, {s: ckpt_tree(1, s) for s in range(2)})
        for i in (0, 1):  # permanent: processes stopped, never restarted
            c.heartbeats[i].stop()
            await c.chunkservers[i].stop()
        mgr = _port_mgr(client, base, num_shards=2, ec=(3, 2),
                        hot_copies=False)
        await _port_restores_both_ways(mgr, 1, 2)
    finally:
        await c.stop()


async def test_port_restore_falls_back_from_hot_to_ec(tmp_path):
    c, client = await _ready(tmp_path, n_cs=5)
    try:
        base = "/ckpt/fallback"
        await ref.CheckpointManager(client, base, num_shards=1).save(
            1, {0: ckpt_tree(1, 0)})
        await client.delete_file(ckptpaths.shard_data_path(base, 1, 0))
        mgr = _port_mgr(client, base, num_shards=1)
        assert_restores_bit_exact(await mgr.restore(), 1)
        assert mgr.stats["degraded_shard_reads"] == 1
        dev = await mgr.restore(device=CPU)
        assert_restores_bit_exact({0: _as_numpy(dev[0])}, 1)
        assert mgr.stats["degraded_shard_reads"] == 2
        # Both copies gone: the restore gives up, naming the shard.
        await client.delete_file(ckptpaths.shard_ec_path(base, 1, 0))
        for device in (None, CPU):
            with pytest.raises(port.DegradedRestoreError, match="shard 0"):
                await mgr.restore(device=device)
    finally:
        await c.stop()


async def test_port_resumed_save_skips_durable_shards(tmp_path):
    c, client = await _ready(tmp_path)
    try:
        base = "/ckpt/resume"
        mgr = port.CheckpointManager(client, base, num_shards=2, ec=(2, 1),
                                     scopes=resilience)
        await mgr.save_shard(5, 0, ckpt_tree(5, 0))
        assert await mgr.list_steps() == []
        mgr2 = port.CheckpointManager(client, base, num_shards=2, ec=(2, 1),
                                      scopes=resilience)
        await mgr2.save(5, {s: ckpt_tree(5, s) for s in range(2)})
        assert mgr2.stats["shards_skipped"] == 2  # shard 0: .bin + .ec
        assert mgr2.stats["shards_written"] == 2
        assert await mgr2.latest_step() == 5
        # The reference restores what the port saved, and the reference's
        # content ETag probe finds the port's files durable.
        refm = ref.CheckpointManager(client, base, num_shards=2, ec=(2, 1))
        assert_restores_bit_exact(await refm.restore(), 5)
        await refm.save(5, {s: ckpt_tree(5, s) for s in range(2)})
        assert refm.stats["shards_skipped"] == 4
        assert refm.stats["shards_written"] == 0
    finally:
        await c.stop()


async def test_port_torn_checkpoint_never_listed_or_restorable(tmp_path):
    c, client = await _ready(tmp_path)
    try:
        base = "/ckpt/torn"
        mgr = port.CheckpointManager(client, base, num_shards=2, ec=None)
        await mgr.save(1, {s: ckpt_tree(1, s) for s in range(2)})
        await mgr.save_shard(2, 0, ckpt_tree(2, 0))
        assert await mgr.list_steps() == [1]
        with pytest.raises(port.CheckpointNotFoundError):
            await mgr.read_manifest(2)
        with pytest.raises(port.IncompleteCheckpointError):
            await mgr.commit(2)
        await client.create_file(
            ckptpaths.staged_manifest_path(base, 3), b"{}", overwrite=True)
        assert await mgr.list_steps() == [1]
        assert_restores_bit_exact(await mgr.restore(), 1)
        refm = ref.CheckpointManager(client, base, num_shards=2, ec=None)
        assert await refm.list_steps() == [1]
        assert_restores_bit_exact(await refm.restore(), 1)
    finally:
        await c.stop()


async def test_port_publish_is_idempotent_and_monotonic(tmp_path):
    c, client = await _ready(tmp_path)
    try:
        base = "/ckpt/mono"
        mgr = port.CheckpointManager(client, base, num_shards=1, ec=None)
        await mgr.save(2, {0: ckpt_tree(2, 0)})
        await mgr.commit(2)
        assert mgr.stats["already_published"] == 1
        assert mgr.stats["commits"] == 2
        assert await mgr.list_steps() == [2]
        zombie = port.CheckpointManager(client, base, num_shards=1, ec=None)
        await zombie.save_shard(1, 0, ckpt_tree(1, 0))
        with pytest.raises(RefDfsError, match="stale"):
            await zombie.commit(1)
        assert await mgr.list_steps() == [2]
        assert_restores_bit_exact(
            await ref.CheckpointManager(client, base, num_shards=1,
                                        ec=None).restore(), 2)
    finally:
        await c.stop()


async def test_port_prune_and_gc_incomplete_under_resilience_scopes(tmp_path):
    c, client = await _ready(tmp_path)
    try:
        base = "/ckpt/gc"
        mgr = port.CheckpointManager(client, base, num_shards=1, ec=None,
                                     scopes=resilience)
        for step in (1, 2, 3):
            await mgr.save(step, {0: ckpt_tree(step, 0)})
        assert await mgr.prune(keep=2) == [1]
        assert await mgr.list_steps() == [2, 3]
        assert await client.list_files(ckptpaths.step_prefix(base, 1)) == []
        abandoned = ckptpaths.shard_data_path(base, 0, 0)
        await client.create_file(abandoned, b"abandoned save")
        await mgr.save_shard(4, 0, ckpt_tree(4, 0))  # in flight, not stale
        # Under an expired ambient deadline: the GC is shielded from it.
        with resilience.deadline_scope(0.001):
            await asyncio.sleep(0.01)
            deleted = await mgr.gc_incomplete(max_age_ms=10**9)
        assert deleted == [abandoned]
        assert mgr.stats["gc_deleted"] == 1
        assert await client.list_files(ckptpaths.step_prefix(base, 4)) != []
        assert_restores_bit_exact(await mgr.restore(), 3)
        assert_restores_bit_exact(
            await ref.CheckpointManager(client, base, num_shards=1,
                                        ec=None).restore(), 3)
        with pytest.raises(ValueError):
            await mgr.prune(keep=0)
    finally:
        await c.stop()


async def test_budgets_reach_the_reference_client(tmp_path):
    """``scopes=tpudfs.common.resilience``: the manager's budgets are the
    reference client's ambient deadline, the tenant its identity."""
    c, client = await _ready(tmp_path)
    try:
        seen = []

        class Spy:
            def __getattr__(self, name):
                return getattr(client, name)

            async def get_file(self, path):
                seen.append((resilience.remaining_budget(),
                             resilience.current_tenant()))
                return await client.get_file(path)

        base = "/ckpt/budget"
        await ref.CheckpointManager(client, base, num_shards=1,
                                    ec=None).save(1, {0: ckpt_tree(1, 0)})
        mgr = port.CheckpointManager(Spy(), base, num_shards=1, ec=None,
                                     restore_budget_s=30.0, tenant="job-7",
                                     scopes=resilience)
        assert_restores_bit_exact(await mgr.restore(), 1)
        budget, tenant = seen[-1]  # the shard read, inside the op scope
        assert 0 < budget <= 30.0 and tenant == "job-7"
        # The no-op default installs neither.
        plain = port.CheckpointManager(Spy(), base, num_shards=1, ec=None,
                                       restore_budget_s=30.0, tenant="job-7")
        await plain.restore()
        assert seen[-1][0] is None and seen[-1][1] != "job-7"
        # An exhausted budget is a read error the fallback chain reports.
        mgr.restore_budget_s = 1e-9
        manifest = await mgr.read_manifest(1)
        with pytest.raises(port.DegradedRestoreError):
            await mgr.restore_shard(manifest, 0)
    finally:
        await c.stop()
