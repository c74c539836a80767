"""Port parity for sharded checkpoints: ``tpudfs_torch.gpu.checkpoint``
against the JAX package's ``tpudfs.tpu.checkpoint``, bit-exact (payloads
and CRCs are byte functions: no tolerance). The payload format and the
namespace layout byte for byte; on the reference ``MiniCluster`` the
reference manager saves and the port restores (host arrays, and tensors on
the CPU device through the port's ``HbmReader``: healthy, through the EC
cold copy with two chunkservers dead, and through the hot → EC fallback);
the port's own save (resume, torn checkpoints, idempotent and monotonic
publish, prune and GC under the reference's resilience scopes), which the
reference manager then restores; the device restore of every payload
dtype on the port's ``LocalClient``; bf16 and float8 tensors packed as the
reference packs their ml_dtypes arrays, bf16 checkpoints crossing both
packages, and the 8-byte widths the port's device restore keeps where the
reference's narrows them."""

import asyncio

import ml_dtypes
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
from tpudfs_torch.common import ckptpaths, trace
from tpudfs_torch.common.checksum import crc32c, crc32c_combine
from tpudfs_torch.gpu import checkpoint as port
from tpudfs_torch.gpu import u32_to_numpy
from tpudfs_torch.gpu.hbm_reader import HbmReader

CPU = torch.device("cpu")


def _tree(seed: int) -> dict:
    """Every payload dtype of the port's map that numpy has (bf16 is in
    ``_raw_bit_trees``), odd sizes included."""
    rng = np.random.default_rng(seed)
    return {
        "w/f4": rng.standard_normal(1000, dtype=np.float32).reshape(10, 100),
        "w/f2": rng.standard_normal(333).astype(np.float16),
        "w/f8": rng.standard_normal(77),
        "w/c8": (rng.standard_normal(21) + 1j * rng.standard_normal(21))
        .astype(np.complex64),
        "w/c16": rng.standard_normal((3, 5)) + 1j * rng.standard_normal(
            (3, 5)),
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
    for s in ("<f4", "<i4", "<u4", "|i1", "|u1", "<i8", "<f8", "<f2",
              "<c8", "<c16", "<V2"):
        assert port.torch_dtype(s).itemsize == np.dtype(s).itemsize
    assert port.torch_dtype("<V2") == torch.bfloat16
    assert port.torch_dtype("<c8") == torch.complex64
    assert port.torch_dtype("<c16") == torch.complex128
    # What no restore can name again raises, saying why.
    with pytest.raises(ValueError, match="'<V1': ml_dtypes' 1-byte"):
        port.torch_dtype("<V1")
    with pytest.raises(ValueError, match="'<f1': numpy cannot read it"):
        port.torch_dtype("<f1")


# ----------------------------------- dtypes numpy lacks (bf16, float8)


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _raw_bit_trees(seed: int) -> tuple[dict, dict]:
    """The same bits as a torch tree and as an ml_dtypes/numpy tree: bf16
    (odd sizes, a scalar, an empty tensor), every float8 type of
    ``RAW_DTYPES``, complex64 and complex128."""
    rng = np.random.default_rng(seed)
    torch_tree, np_tree = {}, {}
    shapes = {"a": (7, 3), "b": (1001,), "c": (), "d": (0, 2)}
    for dtype in port.RAW_DTYPES:
        bits_t = {1: np.uint8, 2: np.uint16}[dtype.itemsize]
        for key, shape in shapes.items():
            bits = rng.integers(0, np.iinfo(bits_t).max, size=shape,
                                dtype=bits_t, endpoint=True)
            name = f"{_name(dtype)}/{key}"
            torch_tree[name] = torch.from_numpy(np.array(bits)).view(dtype)
            np_tree[name] = bits.view(getattr(ml_dtypes, _name(dtype)))
    for name, dt in (("c8", np.complex64), ("c16", np.complex128)):
        z = (rng.standard_normal(37) + 1j * rng.standard_normal(37)).astype(dt)
        torch_tree[name], np_tree[name] = torch.from_numpy(z.copy()), z
    return torch_tree, np_tree


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_raw_bit_dtypes_matches_reference(seed):
    """A torch tree of bf16, float8 and complex tensors packs to the payload
    and specs the reference packs for the same bits as ml_dtypes arrays:
    the content ETag is the same across packages."""
    torch_tree, np_tree = _raw_bit_trees(seed)
    payload, specs = port.pack_shard(torch_tree)
    ref_payload, ref_specs = ref.pack_shard(np_tree)
    assert payload == ref_payload
    assert [s.to_dict() for s in specs] == [s.to_dict() for s in ref_specs]
    assert {s.dtype for s in specs} == {"<V2", "<V1", "<f1", "<c8", "<c16"}
    # ml_dtypes arrays given to the port go through np.asarray, as in the
    # reference.
    assert port.pack_shard(np_tree)[0] == payload
    # A non-contiguous bf16 tensor packs in C order, as numpy does.
    w = torch_tree["bfloat16/a"]
    assert port.pack_shard({"w": w.t()})[0] == \
        ref.pack_shard({"w": np_tree["bfloat16/a"].T})[0]


@pytest.mark.parametrize("dtype", list(port.RAW_DTYPES), ids=_name)
def test_raw_dtype_strings_are_ml_dtypes(dtype):
    """Each constant is the string ml_dtypes records for the type of the
    same name, and ``"<V2"`` names bf16 alone among ml_dtypes' types."""
    assert port.RAW_DTYPES[dtype] == \
        np.dtype(getattr(ml_dtypes, _name(dtype))).str
    v2 = [n for n in dir(ml_dtypes)
          if isinstance(getattr(ml_dtypes, n), type)
          and issubclass(getattr(ml_dtypes, n), np.generic)
          and np.dtype(getattr(ml_dtypes, n)).str == "<V2"]
    assert v2 == ["bfloat16"]


@pytest.mark.parametrize("dtype", [torch.complex32, torch.uint4, torch.int4,
                                   torch.float4_e2m1fn_x2], ids=_name)
def test_pack_refuses_dtypes_numpy_lacks(dtype):
    t = torch.zeros(8, dtype=torch.uint8).view(dtype)
    with pytest.raises(TypeError, match=f"cannot checkpoint a {dtype} "):
        port.pack_shard({"w": t})


# --------------------------------------------- device restore, LocalClient


async def test_device_restore_every_dtype_on_local_client(tmp_path):
    """Every dtype through ``restore_shard_device`` on the port's
    ``LocalClient``: every tensor is a view of one word stream, those that
    are not 4-byte words checked by their own CRC; the same tree as
    ``unpack_shard``."""
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
    assert set(stage) == {"read", "combined_crc", "assemble", "bounce",
                          "bounce_copy", "bounce_crc"}
    words = {out[n].untyped_storage().data_ptr() for n in tree}
    assert len(words) == 1
    assert out["w/f4"].dtype == torch.float32 and out["opt/u4"].dtype == \
        torch.uint32 and out["flags/b1"].dtype == torch.bool
    # A manifest CRC that disagrees with the blocks' fails both copies.
    with pytest.raises(port.DegradedRestoreError):
        await port.restore_shard_device(
            HbmReader(client, [CPU]), client, {**spec, "crc32c": 1}, CPU,
            stats)
    assert stats["degraded_shard_reads"] == 1


def _local_spec(tmp_path, tree: dict, block_size: int = 4096, *,
                cold: bool = False, packed: tuple | None = None):
    """``tree`` packed (or ``packed``, a hand-built (payload, tensor
    specs)) and laid out as the manager saves it; ``cold``: the hot copy's
    replicas are on no store and shard 0 of every cold block is lost, so
    the restore falls back and rebuilds every block."""
    payload, specs = packed or port.pack_shard(tree)
    stores, metas = chip_smoke.lay_out_shard(
        tmp_path, np.frombuffer(payload, dtype=np.uint8),
        block_size=block_size, hot="/c/hot", cold="/c/ec")
    client = LocalClient(stores, metas)
    if cold:
        for b in metas["/c/hot"]["blocks"]:
            b["locations"] = ["gone:1"]
        chip_smoke._drop_shards(client, metas["/c/ec"], (0,))
    spec = {"shard": 0, "path": "/c/hot", "ec_path": "/c/ec",
            "size": len(payload), "crc32c": crc32c(payload),
            "tensors": [s if isinstance(s, dict) else s.to_dict()
                        for s in specs]}
    return client, spec, payload


async def test_device_restore_bf16_and_complex_on_local_client(tmp_path):
    """bf16, complex64 and complex128 come back in their torch dtypes, bit
    for bit, as views of the word stream; the host path gives ``|V2``
    arrays of the same bytes, as the reference's does."""
    torch_tree, _ = _raw_bit_trees(3)
    tree = {k: v for k, v in torch_tree.items()
            if k.startswith("bfloat16/") or k in ("c8", "c16")}
    tree["f4"] = torch.arange(100, dtype=torch.float32)
    client, spec, payload = _local_spec(tmp_path, tree)
    stage = {}
    out = await port.restore_shard_device(
        HbmReader(client, [CPU]), client, spec, CPU,
        {"degraded_shard_reads": 0}, stage_s=stage)
    host = port.unpack_shard(payload, spec["tensors"])
    for name, want in tree.items():
        got = out[name]
        assert (got.dtype, got.shape, got.device) == \
            (want.dtype, want.shape, CPU), name
        raw = got.reshape(-1).view(torch.uint8).numpy().tobytes()
        assert raw == want.reshape(-1).view(torch.uint8).numpy().tobytes()
        assert raw == host[name].tobytes(), name
    assert out["bfloat16/b"].dtype == torch.bfloat16
    assert host["bfloat16/b"].dtype == np.dtype("V2")
    assert stage["bounce"] > 0
    assert stage["bounce_crc"] > 0
    assert stage["bounce"] == pytest.approx(stage["bounce_copy"]
                                            + stage["bounce_crc"])


#: The tensors of ``_non_word_tree`` that are not 4-byte words.
NON_WORD = ("c16", "c8", "flags", "model", "step")


def _non_word_tree(seed: int) -> dict:
    """bf16 weights, int8 flags, an int64 step, complex64 and complex128
    tensors beside fp32 ones, odd sizes included."""
    g = torch.Generator().manual_seed(seed)
    return {"model": torch.randn(3001, generator=g).to(torch.bfloat16),
            "flags": torch.randint(-128, 128, (13,), dtype=torch.int8,
                                   generator=g),
            "step": torch.tensor(2**40 + seed, dtype=torch.int64),
            "c8": torch.randn(21, dtype=torch.complex64, generator=g),
            "c16": torch.randn(3, 5, dtype=torch.complex128, generator=g),
            "params": torch.randn(1000, generator=g)}


def _restore_cpu(client, spec) -> dict:
    return asyncio.run(port.restore_shard_device(
        HbmReader(client, [CPU]), client, spec, CPU,
        {"degraded_shard_reads": 0}))


def _bytes(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _tensor_counts(before: dict) -> dict:
    after = trace.counts()
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in ("restore.tensor_crc_bytes", "restore.tensor_clones")}


@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
def test_non_word_tensors_are_views_checked_by_their_own_crc(tmp_path, cold):
    """bf16, int8, int64, complex64 and complex128 tensors come back as
    views of the word stream (one storage with the fp32 ones), bit-exact
    against ``unpack_shard`` and against the reference's
    ``_restore_shard_device`` (JAX's 64-bit mode keeps its 8-byte widths;
    it has no device restore of bf16, so the bf16 weights are left out of
    its spec, and a cold restore reads its cold copy alone); the counters
    give the bytes checked by their own CRC and no clone."""
    import jax

    from tpudfs.tpu.hbm_reader import HbmReader as RefHbmReader

    tree = _non_word_tree(4)
    client, spec, payload = _local_spec(tmp_path, tree, cold=cold)
    before = trace.counts()
    out = _restore_cpu(client, spec)
    assert _tensor_counts(before) == {
        "restore.tensor_crc_bytes": sum(t["size"] for t in spec["tensors"]
                                        if t["name"] in NON_WORD),
        "restore.tensor_clones": 0}
    host = port.unpack_shard(payload, spec["tensors"])
    for name, want in tree.items():
        got = out[name]
        assert (got.dtype, got.shape, got.device) == \
            (want.dtype, want.shape, CPU), name
        assert _bytes(got) == _bytes(want) == host[name].tobytes(), name
    assert len({t.untyped_storage().data_ptr() for t in out.values()}) == 1
    client.block_size = 4096  # what the reference's manager asks of a client
    jdev = jax.devices("cpu")[0]
    mgr = ref.CheckpointManager(client, "/c", num_shards=1, ec=None,
                                reader=RefHbmReader(client, [jdev]))
    # Cold: straight to the cold copy, as the reference's fallback takes
    # only its own package's DfsError.
    no_bf16 = {**spec, "path": None if cold else spec["path"],
               "tensors": [t for t in spec["tensors"]
                           if t["name"] != "model"]}
    with jax.enable_x64(True):
        theirs = asyncio.run(mgr._restore_shard_device(no_bf16, jdev))
    assert sorted(theirs) == sorted(set(tree) - {"model"})
    for name, arr in theirs.items():
        arr = np.asarray(arr)
        assert arr.dtype == host[name].dtype, name
        assert arr.tobytes() == _bytes(out[name]), name


@pytest.mark.parametrize("name", NON_WORD)
@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
def test_a_flipped_tensor_crc_fails_naming_the_tensor(tmp_path, cold, name):
    """A spec whose CRC of one tensor that is not 4-byte words is one bit
    off fails the restore with ``ChecksumMismatchError`` naming it."""
    client, spec, _ = _local_spec(tmp_path, _non_word_tree(5), cold=cold)
    spec["tensors"] = [{**t, "crc32c": t["crc32c"] ^ (1 << 17)}
                       if t["name"] == name else t for t in spec["tensors"]]
    with pytest.raises(ChecksumMismatchError, match=repr(name)):
        _restore_cpu(client, spec)


def _hand_packed(seed: int) -> tuple[bytes, list[dict], dict]:
    """A payload no packer writes: 4 uint8 flags at offset 0, an int64
    tensor right after them at offset 4 (which 8 does not divide, and
    which fills the flags' chunk gap), fp32 weights at 512."""
    rng = np.random.default_rng(seed)
    tree = {"flags": rng.integers(0, 256, 4, dtype=np.uint8),
            "i8": rng.integers(-2**62, 2**62, 37, dtype=np.int64),
            "w": rng.standard_normal(100, dtype=np.float32)}
    payload, specs, offsets = bytearray(), [], (0, 4, 512)
    for (name, arr), off in zip(tree.items(), offsets):
        payload.extend(b"\0" * (off - len(payload)))
        raw = arr.tobytes()
        specs.append({"name": name, "dtype": arr.dtype.str,
                      "shape": list(arr.shape), "offset": off,
                      "size": len(raw), "crc32c": crc32c(raw)})
        payload.extend(raw)
    return bytes(payload), specs, tree


@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
def test_an_offset_its_item_size_does_not_divide_takes_a_clone(tmp_path,
                                                               cold):
    """The hand-packed payload: the int64 tensor at offset 4 is a device
    clone, counted once; the flags stay a view; both bit-exact."""
    payload, specs, tree = _hand_packed(6)
    client, spec, _ = _local_spec(tmp_path, None, cold=cold,
                                  packed=(payload, specs))
    before = trace.counts()
    out = _restore_cpu(client, spec)
    assert _tensor_counts(before) == {"restore.tensor_crc_bytes": 4 + 296,
                                      "restore.tensor_clones": 1}
    for name, want in tree.items():
        assert out[name].numpy().tobytes() == want.tobytes(), name
        assert out[name].dtype == port.torch_dtype(want.dtype.str)
    stream = out["w"].untyped_storage().data_ptr()
    assert out["flags"].untyped_storage().data_ptr() == stream
    assert out["i8"].untyped_storage().data_ptr() != stream


def test_padded_tensor_crcs_carry_each_crc_across_the_zeros():
    """What a card computes, by the plain twin: each tensor's CRC over its
    zero-padded chunk range is its own CRC carried across the zeros
    (``crc32c_combine(crc, crc32c(zeros), pad)``), for every tensor a
    packer writes and for the hand-packed ones, whose ranges the spec's
    offsets send through a zero-padded copy; one bit off in a tensor's
    CRC, and the verdict is no; under portbench's ``no_verify`` control
    (a host CRC that always agrees) it is yes."""
    from portbench import faults

    tree = _non_word_tree(7)
    payload, specs = port.pack_shard(tree)
    hand, hand_specs, _ = _hand_packed(8)
    for payload, tensors, offsets in (
            (payload, [s.to_dict() for s in specs if s.name in NON_WORD],
             [s.offset for s in specs]),
            (hand, hand_specs[:2], [s["offset"] for s in hand_specs])):
        stream = torch.frombuffer(
            bytearray(payload + bytes(-len(payload) % 512)), dtype=torch.uint8)
        got = [int(g) for g in u32_to_numpy(
            port.padded_tensor_crcs(stream, tensors, offsets))]
        pads = [-t["size"] % 512 for t in tensors]
        assert got == [crc32c_combine(t["crc32c"], crc32c(bytes(pad)), pad)
                       for t, pad in zip(tensors, pads)]
        assert any(pads) and got != [t["crc32c"] for t in tensors]
        for t, g in zip(tensors, got):
            off_by_one = {**t, "crc32c": t["crc32c"] ^ (1 << 9)}
            assert port._padded_crc_agrees(t, g)
            assert not port._padded_crc_agrees(off_by_one, g)
            with faults.planted("no_verify"):
                assert port._padded_crc_agrees(off_by_one, g)


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2],
                         ids=_name)
async def test_device_restore_refuses_v1_and_f1(tmp_path, dtype):
    """``"<V1"`` and ``"<f1"`` name no single type: the device restore
    refuses them (the reference cannot read them back either)."""
    bits = torch.arange(64, dtype=torch.uint8).view(dtype)
    client, spec, _ = _local_spec(tmp_path, {"w": bits})
    with pytest.raises(ValueError, match=port.RAW_DTYPES[dtype]):
        await port.restore_shard_device(HbmReader(client, [CPU]), client,
                                        spec, CPU, {"degraded_shard_reads": 0})


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


async def test_bf16_checkpoints_cross_both_packages(tmp_path):
    """The reference saves a ``jnp.bfloat16`` leaf and the port restores
    it as ``torch.bfloat16``, bit-exact; the port saves a torch bf16 tree,
    the reference's host restore gives ``|V2`` arrays of the same bytes and
    its content-ETag probe finds the port's files durable."""
    import jax.numpy as jnp

    c, client = await _ready(tmp_path)
    try:
        rng = np.random.default_rng(11)
        bits = rng.integers(0, 1 << 16, 3001, dtype=np.uint16)
        f4 = rng.standard_normal(513, dtype=np.float32)
        base = "/ckpt/bf16"
        saver = ref.CheckpointManager(client, base, num_shards=1, ec=(2, 1))
        await saver.save(1, {0: {
            "model": jnp.asarray(bits.view(ml_dtypes.bfloat16)),
            "params": jnp.asarray(f4), "step": np.asarray(1, np.int64)}})
        mgr = _port_mgr(client, base, num_shards=1, ec=(2, 1))
        dev = (await mgr.restore(1, device=CPU))[0]
        assert dev["model"].dtype == torch.bfloat16
        assert np.array_equal(dev["model"].view(torch.uint16).numpy(), bits)
        assert np.array_equal(dev["params"].numpy(), f4)
        host = (await mgr.restore(1))[0]
        _assert_tree_equal(host, (await saver.restore(1))[0])
        assert host["model"].dtype == np.dtype("V2")

        torch_tree = {"model": torch.from_numpy(bits.copy())
                      .view(torch.bfloat16),
                      "params": torch.from_numpy(f4.copy())}
        await mgr.save(2, {0: torch_tree})
        got = (await saver.restore(2))[0]
        assert got["model"].dtype == np.dtype("V2")
        assert got["model"].tobytes() == bits.tobytes()
        assert got["params"].tobytes() == f4.tobytes()
        dev = (await mgr.restore(2, device=CPU))[0]
        assert torch.equal(dev["model"].view(torch.uint16),
                           torch_tree["model"].view(torch.uint16))
        await saver.save(2, {0: {"model": bits.view(ml_dtypes.bfloat16),
                                 "params": f4}})
        assert saver.stats["shards_skipped"] == 2  # .bin + .ec
    finally:
        await c.stop()


async def test_device_restore_keeps_the_widths_the_reference_narrows(
        tmp_path):
    """A deliberate difference: under JAX's default config the reference's
    device restore narrows 8-byte tensors to 32 bits (``jax.device_put``);
    the port's keeps each at its saved width, bit-exact with
    ``unpack_shard``."""
    import jax

    from tpudfs.tpu.hbm_reader import HbmReader as RefHbmReader

    assert not jax.config.jax_enable_x64  # JAX's default
    c, client = await _ready(tmp_path)
    try:
        rng = np.random.default_rng(12)
        tree = {"step": np.asarray(1000, np.int64),
                "i8": rng.integers(-1000, 1000, 33, dtype=np.int64),
                "f8": rng.standard_normal(33),
                "c16": rng.standard_normal(9) + 1j * rng.standard_normal(9)}
        base = "/ckpt/x64"
        jdev = jax.devices()[0]
        saver = ref.CheckpointManager(client, base, num_shards=1, ec=None,
                                      reader=RefHbmReader(client, [jdev]))
        await saver.save(1, {0: tree})
        narrowed = (await saver.restore(1, device=jdev))[0]
        assert {k: np.asarray(v).dtype.str for k, v in narrowed.items()} == \
            {"step": "<i4", "i8": "<i4", "f8": "<f4", "c16": "<c8"}
        for k, v in narrowed.items():
            assert np.array_equal(np.asarray(v), tree[k].astype(v.dtype))
        mgr = _port_mgr(client, base, num_shards=1, ec=None)
        dev = (await mgr.restore(1, device=CPU))[0]
        host = (await mgr.restore(1))[0]
        for k, want in tree.items():
            assert dev[k].dtype == port.torch_dtype(want.dtype.str)
            assert dev[k].element_size() == want.itemsize
            assert dev[k].numpy().tobytes() == host[k].tobytes() == \
                want.tobytes(), k
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
