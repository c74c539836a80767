"""Port parity for chain replication and the RS shard scatter/gather:
``tpudfs_torch.gpu.ici_replication`` on N CPU positions against the JAX
package's ``tpudfs.tpu.ici_replication`` on N of the 8 virtual CPU devices
``tests/conftest.py`` sets up. The same seeded numpy words and CRCs go into
both; replicas, ok bits, acks, shards, reconstructed data and parity must be
equal, bit for bit (integer functions: no tolerance). The JAX programs are
built once per module: each ``shard_map`` compile costs seconds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from tpudfs.common import erasure as ref_erasure
from tpudfs.common.checksum import crc32c_chunks
from tpudfs.tpu import ici_replication as ref
from tpudfs_torch.common import erasure as port_erasure
from tpudfs_torch.gpu import ici_replication as port
from tpudfs_torch.gpu import state
from tpudfs_torch.gpu.crc32c_cuda import bytes_to_words
from torch_ring import shard, unshard

CPU = torch.device("cpu")


def _blocks(n: int, chunks: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, chunks * 512, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _inputs(blocks: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    data = b"".join(blocks)
    return bytes_to_words(data), crc32c_chunks(data).astype(np.uint32)


def _ref_put(arr: np.ndarray, mesh) -> jax.Array:
    return jax.device_put(jnp.asarray(arr),
                          NamedSharding(mesh, P(tuple(mesh.axis_names))))


def _port_mesh(shape, names=("hosts",)) -> port.Mesh:
    return port.Mesh(np.array([CPU] * int(np.prod(shape)),
                              dtype=object).reshape(shape), names)


def _same(port_parts, ref_arr) -> None:
    np.testing.assert_array_equal(unshard(port_parts), np.asarray(ref_arr))


def _data_of(recon: np.ndarray, i: int, k: int, nbytes: int) -> bytes:
    """Host i's block from the (N, k, S, 128) reconstructed data shards."""
    per = -(-nbytes // k)
    slen = -(-per // 512) * 512
    return b"".join(recon[i, r].astype("<u4").tobytes()[:slen]
                    for r in range(k))[:nbytes]


@pytest.fixture(scope="module")
def ring4():
    """The reference's 4-device, R=3 replicator (one compile per shape)."""
    mesh = ref.make_mesh(jax.devices()[:4])
    return mesh, ref.IciReplicator(mesh, replication=3)


# ------------------------------------------------------------- the chain


def test_chain_layout_matches_reference(ring4):
    mesh, rep = ring4
    words, crcs = _inputs(_blocks(4, 2, seed=2))
    want = rep.replicate(_ref_put(words, mesh), _ref_put(crcs, mesh))
    pmesh = port.make_mesh([CPU] * 4)
    got = port.IciReplicator(pmesh, 3).replicate(shard(words, pmesh),
                                                 shard(crcs, pmesh))
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert int(got[2]) == int(want[2]) == 4
    assert got[2].dtype == torch.int32 and got[2].dim() == 0
    # Host i holds the groups of hosts i, i-1, i-2.
    rep_np = unshard(got[0]).reshape(4, 3, 2, 128)
    for host in range(4):
        for r in range(3):
            np.testing.assert_array_equal(
                rep_np[host, r], words.reshape(4, 2, 128)[(host - r) % 4])


def test_corruption_flags_the_same_positions(ring4):
    mesh, rep = ring4
    words, crcs = _inputs(_blocks(4, 1, seed=3))
    crcs[1] ^= 0xDEADBEEF  # host 1's expected checksum, poisoned
    want = rep.replicate(_ref_put(words, mesh), _ref_put(crcs, mesh))
    pmesh = port.make_mesh([CPU] * 4)
    replicas, ok, acks = port.IciReplicator(pmesh, 3).replicate(
        shard(words, pmesh), shard(crcs, pmesh))
    assert unshard(ok).tolist() == np.asarray(want[1]).tolist() \
        == [True, False, False, False]
    assert int(acks) == int(want[2]) == 1
    _same(replicas, want[0])


def test_single_position_ring_is_the_degenerate_chain():
    """R=3 on a one-position mesh is accepted (every hop lands on the
    sender), as the reference accepts it on one device."""
    words, crcs = _inputs(_blocks(1, 3, seed=4))
    mesh = ref.make_mesh(jax.devices()[:1])
    want = ref.IciReplicator(mesh, 3).replicate(_ref_put(words, mesh),
                                                _ref_put(crcs, mesh))
    pmesh = port.make_mesh([CPU])
    got = port.IciReplicator(pmesh, 3).replicate(shard(words, pmesh),
                                                 shard(crcs, pmesh))
    _same(got[0], want[0])
    assert int(got[2]) == int(want[2]) == 1


def test_pod_mesh_2d_chain_and_ec_ride_the_last_axis():
    """(dcn=2, ici=4): the chain and the EC(2,2) scatter and degraded
    gather ride the ici axis in each dcn row; ring position 1 of EVERY row
    serves garbage and each host still reconstructs its data."""
    devs = jax.devices()[:8]
    mesh = JaxMesh(np.array(devs).reshape(2, 4), ("dcn", "ici"))
    pmesh = _port_mesh((2, 4), ("dcn", "ici"))
    C = 2
    blocks = _blocks(8, C, seed=33)
    words, crcs = _inputs(blocks)
    w_ref, c_ref = _ref_put(words, mesh), _ref_put(crcs, mesh)
    w_port, c_port = shard(words, pmesh), shard(crcs, pmesh)

    want = ref.IciReplicator(mesh, 3, axis="ici").replicate(w_ref, c_ref)
    got = port.IciReplicator(pmesh, 3, axis="ici").replicate(w_port, c_port)
    _same(got[0], want[0])
    assert int(got[2]) == int(want[2]) == 8

    k, m = 2, 2
    want = ref.EcShardScatter(mesh, k, m, axis="ici").scatter(w_ref)
    shards, ok, acks = port.EcShardScatter(pmesh, k, m, axis="ici") \
        .scatter(w_port)
    _same(shards, want[0])
    _same(ok, want[1])
    assert int(acks) == int(want[2]) == 8
    broken = np.asarray(want[0]).copy().reshape(2, 4, k + m, -1, 128)
    broken[:, 1] = 0xCD
    broken = broken.reshape(np.asarray(want[0]).shape)
    want = ref.EcShardGather(mesh, k, m, axis="ici").gather(
        _ref_put(broken, mesh), failed=1)
    recon = port.EcShardGather(pmesh, k, m, axis="ici").gather(
        shard(broken, pmesh), failed=1)
    _same(recon, want)
    out = unshard(recon).reshape(8, k, -1, 128)
    for i in range(8):
        assert _data_of(out, i, k, C * 512) == blocks[i], f"host {i}"


@pytest.mark.parametrize("cls,args", [
    ("IciReplicator", (3,)), ("EcShardScatter", (2, 1)),
    ("EcShardGather", (2, 1))])
def test_size1_and_non_last_ring_axes_are_rejected(cls, args):
    """A multi-position mesh whose ring axis has size 1 must raise (zero
    redundancy), and so must a ring axis that is not the last."""
    devs = jax.devices()[:4]
    for shape, names in (((4, 1), ("dcn", "ici")), ((2, 2), ("ici", "dcn"))):
        with pytest.raises(ValueError):
            getattr(ref, cls)(JaxMesh(np.array(devs).reshape(shape), names),
                              *args, axis="ici")
        with pytest.raises(ValueError):
            getattr(port, cls)(_port_mesh(shape, names), *args, axis="ici")


# --------------------------------------------------- write step + parity


def test_replicated_write_step_parity_matches_reference():
    mesh = ref.make_mesh(jax.devices()[:8])
    cph = 6  # chunks per host
    blocks = _blocks(8, cph, seed=4)
    words, crcs = _inputs(blocks)
    want = ref.replicated_write_step(mesh, 3, ec=(6, 3))(
        _ref_put(words, mesh), _ref_put(crcs, mesh))
    pmesh = port.make_mesh([CPU] * 8)
    got = port.replicated_write_step(pmesh, 3, ec=(6, 3))(
        shard(words, pmesh), shard(crcs, pmesh))
    for key in ("replicas", "ok", "parity"):
        _same(got[key], want[key])
    assert int(got["acks"]) == int(want["acks"]) == 8
    for i in (0, 5):
        parity = unshard(got["parity"]).reshape(8, 3, -1)[i]
        assert [bytes(p) for p in parity] == \
            port_erasure.encode(blocks[i], 6, 3)[6:] == \
            ref_erasure.encode(blocks[i], 6, 3)[6:]


# ------------------------------------------------------- degraded gather


@pytest.fixture(scope="module", params=[(2, 1), (2, 2)],
                ids=lambda km: f"rs{km[0]}{km[1]}")
def scattered(request):
    """RS(k,m) scatter of 8 hosts' blocks through the reference and the
    port, plus the reference's gather (built once per (k, m))."""
    k, m = request.param
    mesh = ref.make_mesh(jax.devices())
    pmesh = port.make_mesh([CPU] * 8)
    blocks = _blocks(8, 8, seed=51)
    words, _ = _inputs(blocks)
    want = ref.EcShardScatter(mesh, k, m).scatter(_ref_put(words, mesh))
    got = port.EcShardScatter(pmesh, k, m).scatter(shard(words, pmesh))
    return {"k": k, "m": m, "mesh": mesh, "pmesh": pmesh, "blocks": blocks,
            "ref": want, "port": got,
            "ref_gather": ref.EcShardGather(mesh, k, m),
            "port_gather": port.EcShardGather(pmesh, k, m)}


@pytest.mark.parametrize("failed", [None, 0, 1, 2])
def test_gather_reconstructs_around_a_failed_position(scattered, failed):
    s = scattered
    k, m = s["k"], s["m"]
    _same(s["port"][0], s["ref"][0])
    assert int(s["port"][2]) == int(s["ref"][2]) == 8
    host = np.asarray(s["ref"][0]).copy().reshape(8, k + m, -1, 128)
    if failed is not None:
        host[failed] = 0xAB  # the failed position's whole group is garbage
    broken = host.reshape(np.asarray(s["ref"][0]).shape)
    want = s["ref_gather"].gather(_ref_put(broken, s["mesh"]), failed=failed)
    recon = s["port_gather"].gather(shard(broken, s["pmesh"]),
                                    failed=failed)
    _same(recon, want)
    out = unshard(recon).reshape(8, k, -1, 128)
    for i in range(8):
        assert _data_of(out, i, k, 8 * 512) == s["blocks"][i], f"host {i}"
    # The reference's decode matrices, carried across, drive the same result.
    key = f"gather_matrices/{k},{m}/8/{'none' if failed is None else failed}"
    ref_mats = np.asarray(s["ref_gather"]._matrices(failed))
    np.testing.assert_array_equal(state.own_arrays([key])[key], ref_mats)
    carried = state.from_reference({key: ref_mats}, CPU)[key]
    assert carried.dtype == torch.uint8
    _same(s["port_gather"].gather(shard(broken, s["pmesh"]),
                                  failed=failed, matrices=carried), want)


def test_gather_rejects_a_small_mesh_and_a_failure_on_one_position():
    with pytest.raises(ValueError):
        ref.EcShardGather(ref.make_mesh(jax.devices()[:2]), 2, 1)
    with pytest.raises(ValueError):
        port.EcShardGather(port.make_mesh([CPU] * 2), 2, 1)
    words, _ = _inputs(_blocks(1, 4, seed=6))
    pmesh = port.make_mesh([CPU])
    shards = port.EcShardScatter(pmesh, 2, 1).scatter(shard(words, pmesh))[0]
    gather = port.EcShardGather(pmesh, 2, 1)
    with pytest.raises(ValueError, match="1-position"):
        gather.gather(shards, failed=0)
    recon = unshard(gather.gather(shards)).reshape(1, 2, -1, 128)
    assert _data_of(recon, 0, 2, 4 * 512) == words.tobytes()


def test_rs63_full_geometry_on_nine_positions():
    """RS(6,3) with one shard per position (the reference covers this
    geometry in a child process with 12 virtual devices): the placed data
    shards rebuild every block, the parity equals both host encoders', and
    the gather is bit-exact healthy and around positions 0, 4 and 8."""
    k, m, n, C = 6, 3, 9, 12
    blocks = _blocks(n, C, seed=63)
    words, _ = _inputs(blocks)
    pmesh = port.make_mesh([CPU] * n)
    shards, ok, acks = port.EcShardScatter(pmesh, k, m).scatter(
        shard(words, pmesh))
    assert int(acks) == n and unshard(ok).all()
    out = unshard(shards).reshape(n, k + m, -1, 128)
    per = -(-(C * 512) // k)
    slen = -(-per // 512) * 512
    for i in range(n):
        held = [out[(i + j) % n, j].astype("<u4").tobytes()[:slen]
                for j in range(k + m)]
        assert b"".join(held[:k])[: C * 512] == blocks[i]
        want = ref_erasure.encode(blocks[i], k, m)
        assert port_erasure.encode(blocks[i], k, m) == want
        assert [h[:per] for h in held[k:]] == want[k:], f"host {i} parity"
    gather = port.EcShardGather(pmesh, k, m)
    for failed in (None, 0, 4, 8):
        host = out.copy()
        if failed is not None:
            host[failed] = 0xA5
        recon = unshard(gather.gather(
            shard(host.reshape(n * (k + m), -1, 128), pmesh),
            failed=failed)).reshape(n, k, -1, 128)
        for i in range(n):
            assert _data_of(recon, i, k, C * 512) == blocks[i], (failed, i)


def test_hops_copy_even_between_positions_on_one_device():
    """Positions share the CPU device: every replica, shard and gathered row
    is a buffer of its own, so mutating the inputs after the call changes
    nothing that came out."""
    pmesh = port.make_mesh([CPU] * 3)
    words, crcs = _inputs(_blocks(3, 4, seed=8))
    w, c = shard(words, pmesh), shard(crcs, pmesh)
    replicas, _, _ = port.IciReplicator(pmesh, 3).replicate(w, c)
    shards, _, _ = port.EcShardScatter(pmesh, 2, 1).scatter(w)
    recon = port.EcShardGather(pmesh, 2, 1).gather(shards)
    before = [unshard(x).copy() for x in (replicas, shards, recon)]
    for t in w + c + shards:
        t.view(torch.int32).fill_(-1)
    for x, b in zip((replicas, recon), (before[0], before[2])):
        np.testing.assert_array_equal(unshard(x), b)
    storages = {t.untyped_storage().data_ptr() for t in replicas + shards
                + recon + w + c}
    assert len(storages) == len(replicas + shards + recon + w + c)


def test_make_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        assert port.make_mesh().positions()[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.make_mesh()
    assert port.make_mesh([CPU] * 2).shape == {"hosts": 2}
