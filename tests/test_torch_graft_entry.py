"""Port parity for the entry points: ``tpudfs_torch.graft_entry``
against ``__graft_entry__.py``, on CPU positions.

- ``entry()``'s step on ``torch.device("cpu")`` against the reference's,
  run with ``jax.jit`` (bit-exact: integer functions, no tolerance), with
  the expected CRCs as made and with one poisoned;
- the 8-position dryrun leg by leg against the JAX package's functions on
  the 8-device virtual CPU mesh of ``tests/conftest.py``, with the
  same seed-1 inputs in both: the replicated write step with RS(6,3)
  parity, the RS(5,3) scatter, the gather around position 0 with its
  shards garbage, and the 2x4 pod leg's chain and RS(2,2) scatter;
- the 9-position dryrun (that mesh caps at 8) by its own bit-exact
  reconstruction, and every smaller mesh's geometry;
- the live collective-write leg on the reference's ``InprocCluster``, with
  the port's write group attached through a subclass whose ``Error`` is the
  reference's ``IciWriteError`` (the exception its chunkservers catch)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as ref_entry
from tpudfs.common.checksum import crc32c_chunks
from tpudfs.testing.inproc import InprocCluster
from tpudfs.tpu import ici_replication as ref
from tpudfs.tpu.write_group import IciWriteError
from tpudfs_torch import graft_entry as port
from tpudfs_torch.gpu import u32_to_numpy
from tpudfs_torch.gpu.ici_replication import make_mesh
from tpudfs_torch.gpu.write_group import IciWriteGroup
from torch_ring import unshard

CPU = torch.device("cpu")


class ShimGroup(IciWriteGroup):
    """The port's group as the reference chunkserver catches its errors."""

    Error = IciWriteError


def _np(t: torch.Tensor) -> np.ndarray:
    return u32_to_numpy(t) if t.dtype == torch.uint32 else t.numpy()


# ------------------------------------------------------------------ entry


@pytest.fixture(scope="module")
def reference_entry():
    """The reference step, jitted once, and its example arguments."""
    jax.devices()  # a live backend: entry() skips its probe subprocess
    fn, args = ref_entry.entry()
    return jax.jit(fn), args


@pytest.mark.parametrize("poison", [False, True])
def test_entry_step_matches_reference(reference_entry, poison):
    ref_step, (ref_words, ref_crcs) = reference_entry
    step, (words, crcs) = port.entry(CPU)
    np.testing.assert_array_equal(_np(words), np.asarray(ref_words))
    np.testing.assert_array_equal(_np(crcs), np.asarray(ref_crcs))
    ref_crcs = np.asarray(ref_crcs).copy()
    if poison:
        crcs = crcs.clone()
        crcs.view(torch.int32)[5] ^= 0x5A5A5A5A
        ref_crcs[5] ^= 0x5A5A5A5A
    want = ref_step(ref_words, jnp.asarray(ref_crcs))
    got = step(words, crcs)
    assert set(got) == set(want)
    for key in ("chunk_crcs", "parity"):
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]))
    assert got["parity"].shape == (3, 96 * 512 // 6)
    assert got["parity"].dtype == torch.uint8
    for key in ("crc_ok", "write_ok", "write_acks"):
        assert got[key].dim() == 0
        assert got[key].item() == np.asarray(want[key]).item(), key
    assert bool(got["crc_ok"]) is bool(got["write_ok"]) is (not poison)
    assert int(got["write_acks"]) == (0 if poison else 1)


@pytest.mark.parametrize("chunks", [0, 4, 97])
def test_entry_rejects_shards_off_the_128_byte_row(chunks):
    """The step's bytes must split into 6 shards of a multiple of 128
    bytes (the reference's ``rs_encode_device`` requirement)."""
    with pytest.raises(ValueError, match="128"):
        port.entry(CPU, chunks=chunks)


def test_entry_at_another_width_checks_itself():
    step, (words, crcs) = port.entry(CPU, chunks=6 * 5)
    out = step(words, crcs)
    assert bool(out["crc_ok"]) and bool(out["write_ok"])
    np.testing.assert_array_equal(_np(out["chunk_crcs"]), _np(crcs))
    assert out["parity"].shape == (3, 5 * 512)


# ----------------------------------------------------------------- dryrun


@pytest.fixture(scope="module")
def dryrun8():
    """The 8-position dryrun's seed-1 inputs on CPU positions and on the
    8-device virtual mesh."""
    devs = [CPU] * 8
    words, crcs = port.dryrun_inputs(devs, 6, 1)
    host_words, host_crcs = unshard(words), unshard(crcs)
    mesh = JaxMesh(np.array(jax.devices()[:8]), ("hosts",))

    def put(arr, m=mesh):
        return jax.device_put(jnp.asarray(arr),
                              NamedSharding(m, P(tuple(m.axis_names))))

    return {"devs": devs, "words": words, "crcs": crcs, "mesh": mesh,
            "host_words": host_words, "host_crcs": host_crcs, "put": put}


def _same(parts, want) -> None:
    np.testing.assert_array_equal(unshard(parts), np.asarray(want))


def test_dryrun_inputs_carry_their_host_crcs(dryrun8):
    """The expected CRCs are the reference's host CRC of the words'
    bytes, and the words are the seed's, whatever the run."""
    d = dryrun8
    assert d["host_words"].shape == (8 * 6, 128)
    np.testing.assert_array_equal(
        d["host_crcs"], crc32c_chunks(d["host_words"].tobytes()))
    again, _ = port.dryrun_inputs(d["devs"], 6, 1)
    np.testing.assert_array_equal(unshard(again), d["host_words"])
    other, _ = port.dryrun_inputs(d["devs"], 6, 2)
    assert not np.array_equal(unshard(other), d["host_words"])


def test_dryrun_write_leg_matches_reference(dryrun8):
    d = dryrun8
    want = ref.replicated_write_step(d["mesh"], 3, ec=(6, 3))(
        d["put"](d["host_words"]), d["put"](d["host_crcs"]))
    got = port.write_leg(make_mesh(d["devs"]), d["words"], d["crcs"], 3)
    for key in ("replicas", "ok", "parity"):
        _same(got[key], want[key])
    assert int(got["acks"]) == int(want["acks"]) == 8
    assert unshard(got["replicas"]).shape[0] == 8 * 3


def test_dryrun_ec_leg_matches_reference(dryrun8):
    """RS(5,3) on 8 positions, then the gather with ring position 0's
    shards garbage (0xAB in every word, as the reference writes them)."""
    d = dryrun8
    assert port.ec_geometry(8) == (5, 3)
    shards, ok, acks = ref.EcShardScatter(d["mesh"], 5, 3).scatter(
        d["put"](d["host_words"]))
    got = port.ec_leg(make_mesh(d["devs"]), d["words"], 5, 3)
    _same(got["shards"], shards)
    _same(got["ok"], ok)
    assert int(got["acks"]) == int(acks) == 8
    broken = np.asarray(shards).copy()
    rows = broken.shape[0] // 8
    broken[:rows] = 0xAB
    _same(got["broken"], broken)
    assert got["failed"] == 0
    want = ref.EcShardGather(d["mesh"], 5, 3).gather(d["put"](broken),
                                                     failed=0)
    _same(got["recon"], want)
    recon = unshard(got["recon"]).reshape(8, -1)
    np.testing.assert_array_equal(recon[:, : 6 * 128],
                                  d["host_words"].reshape(8, -1))


def test_dryrun_pod_leg_matches_reference(dryrun8):
    """The 2x4 (dcn, ici) pod: the chain x3 and RS(2,2) ride the ici
    axis."""
    d = dryrun8
    geometry = port.pod_geometry(8)
    assert geometry == (2, 4, 3, 2, 2)
    mesh2 = JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4),
                    ("dcn", "ici"))
    w2 = d["put"](d["host_words"], mesh2)
    c2 = d["put"](d["host_crcs"], mesh2)
    replicas, ok, acks = ref.IciReplicator(mesh2, replication=3,
                                           axis="ici").replicate(w2, c2)
    shards, sok, sacks = ref.EcShardScatter(mesh2, 2, 2, axis="ici") \
        .scatter(w2)
    got = port.pod_leg(d["devs"], d["words"], d["crcs"], geometry)
    _same(got["replicas"], replicas)
    _same(got["ok"], ok)
    _same(got["shards"], shards)
    _same(got["scatter_ok"], sok)
    assert int(got["acks"]) == int(acks) == 8
    assert int(got["scatter_acks"]) == int(sacks) == 8


def test_dryrun_body_on_eight_positions(capsys):
    r = port.dryrun_body([CPU] * 8)
    assert (r["positions"], r["replication"], r["write_acks"]) == (8, 3, 8)
    assert r["replica_groups"] == 24 and r["parity_shape"] == [3, 512]
    assert (r["ec"], r["scatter_acks"], r["gather_failed"]) == ([5, 3], 8, 0)
    assert r["exact"] and r["shard_bytes"] == 1024  # ceil(3072/5), chunks
    assert r["pod"] == {"shape": [2, 4], "replication": 3, "ec": [2, 2],
                        "acks": 8, "scatter_acks": 8, "shard_bytes": 1536}
    assert r["live"] is None
    assert set(r["seconds"]) == {"inputs", "write", "scatter_gather", "pod"}
    # The CPU path runs the plain twins: no launch is counted.
    assert r["launches"] == {"crc32c_chunks": 0, "crc32c_blocks": 0,
                             "gf256_matmul": 0}
    assert set(r["leg_launches"]) == set(r["seconds"])
    assert capsys.readouterr().out.strip() == r["message"]
    assert r["message"].startswith("dryrun_multichip OK: 8-position mesh")
    assert "EC(5,3) shard scatter verified" in r["message"]


def test_dryrun_multichip_nine_positions_rs63_and_pod_3x3():
    r = port.dryrun_multichip(9, CPU)
    assert r["devices"] == ["cpu"] * 9
    assert (r["ec"], r["scatter_acks"], r["exact"]) == ([6, 3], 9, True)
    assert r["pod"] == {"shape": [3, 3], "replication": 3, "ec": [1, 2],
                        "acks": 9, "scatter_acks": 9, "shard_bytes": 3072}
    assert r["write_acks"] == 9 and r["replica_groups"] == 27


@pytest.mark.parametrize("n,ec,pod", [
    (1, [1, 1], None), (2, None, None), (3, [2, 1], None),
    (4, [2, 2], [2, 2]), (5, [3, 2], None), (6, [3, 3], [2, 3]),
    (7, [4, 3], None), (12, [6, 3], [2, 6])])
def test_dryrun_geometry_on_every_mesh_size(n, ec, pod):
    """The reference's geometry rules, every branch: RS(k,m) one shard a
    position (none on 2), the pod leg on the smallest factor >= 2."""
    def no_cluster(*_):
        raise AssertionError("a ring under 3 positions builds no cluster")

    live = functools.partial(port.live_collective_write,
                             cluster_factory=no_cluster)
    r = port.dryrun_body([CPU] * n, chunks_per_position=2,
                         live=live if n < 3 else None)
    assert r["ec"] == ec and r.get("exact", ec is None) is True
    assert (r["pod"] or {}).get("shape") == pod
    assert r["write_acks"] == n and r["replication"] == min(3, n)
    if n < 3:
        assert r["live"] == "live collective write skipped (mesh < 3 " \
                            "positions)"


def test_positions_on_the_cpu():
    assert port.positions(3, CPU) == [CPU] * 3
    assert port.positions(1, "cpu") == [CPU]


# ------------------------------------------------------ live write path


def test_live_collective_write_under_composed_faults():
    """The whole dryrun on 8 CPU positions with the live leg on the
    reference's InprocCluster (3 masters, 4 chunkservers): puts ride
    collective rounds, a master failover + 3 puts + a garbage member's EC
    gather run concurrently, and a dead member's put takes the TCP chain."""
    live = functools.partial(port.live_collective_write,
                             cluster_factory=InprocCluster,
                             group_cls=ShimGroup)
    r = port.dryrun_multichip(8, CPU, live=live)
    msg = r["live"]
    rounds, blocks = map(int, re.search(
        r"(\d+) collective round\(s\)/(\d+) blocks on a 4-CS ring",
        msg).groups())
    assert rounds >= 1 and blocks >= 2
    assert "garbage member EC(2,2) gather reconstructed" in msg
    assert "3 puts during failover" in msg
    assert int(re.search(r"\((\d+) fallback\(s\)\)", msg).group(1)) >= 1
    assert r["seconds"]["live"] > 0 and msg in r["message"]
