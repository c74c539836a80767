"""The port's native host engine (``tpudfs_torch/common/native.py``: the g++
build of ``native/crc32c.cc``, ``gf256.cc`` and ``blockio.cc``) on the CPU,
held to no tolerance against its numpy twins and against the reference's
``tpudfs.common.checksum``, ``tpudfs.common.erasure`` and
``tpudfs.chunkserver.blockstore``: CRC32C whole and per chunk, RS encode
and decode on every loss pattern, the store's files byte for byte, and the
store's verified reads and the error class of each fault. Also: each
native entry counts its calls, a failed build raises where the engine is
used (no numpy fallback), and importing the port builds nothing."""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpudfs.chunkserver import blockstore as ref_blockstore
from tpudfs.common import checksum as ref_checksum
from tpudfs.common import erasure as ref_erasure
from tpudfs_torch.chunkserver import blockstore
from tpudfs_torch.common import checksum, erasure, native

REPO = Path(__file__).resolve().parents[1]
SIZES = (0, 1, 511, 512, 513, 4103, (1 << 20) + 1)
KINDS = ("bytes", "bytearray", "memoryview", "ndarray", "tensor")


def _as(kind: str, data: bytes):
    if kind == "bytes":
        return data
    if kind == "bytearray":
        return bytearray(data)
    if kind == "memoryview":
        return memoryview(data)
    arr = np.frombuffer(data, dtype=np.uint8).copy()
    return arr if kind == "ndarray" else torch.from_numpy(arr)


# ------------------------------------------------------------------ CRCs


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES)
def test_crc32c_native_plain_and_reference_agree(size, kind):
    data = np.random.default_rng(size).bytes(size)
    given = _as(kind, data)
    for crc in (0, 0xDEADBEEF):
        want = ref_checksum.crc32c(data, crc)
        assert checksum.crc32c(given, crc) == want
        assert checksum.crc32c_plain(given, crc) == want
    for chunk in (512, 4096, 100):
        want = ref_checksum.crc32c_chunks(data, chunk)
        got = checksum.crc32c_chunks(given, chunk)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(checksum.crc32c_chunks_plain(given, chunk),
                                      want)


def test_crc32c_of_strided_and_wide_inputs():
    """A non-contiguous array and a bf16 tensor are CRCed over their bytes
    in C order, as the plain twin reads them."""
    arr = np.arange(4096, dtype=np.uint32).reshape(64, 64)[:, ::3]
    want = ref_checksum.crc32c(np.ascontiguousarray(arr).tobytes())
    assert checksum.crc32c(arr) == checksum.crc32c_plain(arr) == want
    t = torch.arange(1000, dtype=torch.float32).to(torch.bfloat16)
    raw = t.view(torch.uint8).numpy().tobytes()
    assert checksum.crc32c(t) == ref_checksum.crc32c(raw)
    np.testing.assert_array_equal(checksum.crc32c_chunks(t),
                                  ref_checksum.crc32c_chunks(raw))


# --------------------------------------------------------------- erasure


def _loss_patterns(k: int, m: int):
    for n in range(m + 1):
        yield from itertools.combinations(range(k + m), n)


@pytest.mark.parametrize("k,m", [(3, 2), (6, 3), (5, 3), (2, 2), (1, 2)])
def test_erasure_native_plain_and_reference_agree(monkeypatch, k, m):
    data = np.random.default_rng(k * 10 + m).bytes(10_007)
    shards = erasure.encode(data, k, m)
    assert shards == ref_erasure.encode(data, k, m)
    with monkeypatch.context() as plain:
        plain.setattr(erasure, "_gf_matmul", erasure._gf_matmul_plain)
        assert erasure.encode(data, k, m) == shards
    for lost in _loss_patterns(k, m):
        given = [None if i in lost else s for i, s in enumerate(shards)]
        got = erasure.decode(list(given), k, m, len(data))
        assert got == data, lost
        assert ref_erasure.decode(list(given), k, m, len(data)) == data
        with monkeypatch.context() as plain:
            plain.setattr(erasure, "_gf_matmul", erasure._gf_matmul_plain)
            assert erasure.decode(list(given), k, m, len(data)) == data


@pytest.mark.parametrize("rows,cols", [(1, 1), (3, 6), (6, 6), (4, 9)])
def test_gf_matmul_native_equals_plain(rows, cols):
    rng = np.random.default_rng(rows * cols)
    mat = rng.integers(0, 256, (rows, cols), dtype=np.uint8)
    shards = rng.integers(0, 256, (cols, 4099), dtype=np.uint8)
    np.testing.assert_array_equal(erasure._gf_matmul(mat, shards),
                                  erasure._gf_matmul_plain(mat, shards))


# ----------------------------------------------------------- block store


@pytest.mark.parametrize("chunk", [512, 4096])
@pytest.mark.parametrize("size", [0, 1, 513, 65536 + 7])
def test_store_write_files_equal_the_references(tmp_path, size, chunk):
    """The fused native write and the write with CRCs in hand both leave
    a data file and sidecar byte-identical with the reference store's."""
    data = np.random.default_rng(size).bytes(size)
    ref = ref_blockstore.BlockStore(tmp_path / "ref", chunk_size=chunk)
    port = blockstore.BlockStore(tmp_path / "port", chunk_size=chunk)
    held = blockstore.BlockStore(tmp_path / "held", chunk_size=chunk)
    want = ref.write("blk_1", data)
    sums = checksum.crc32c_chunks_plain(data, chunk)
    np.testing.assert_array_equal(sums, want)
    np.testing.assert_array_equal(port.write("blk_1", data), want)
    np.testing.assert_array_equal(held.write("blk_1", data, sums), want)
    for name in ("blk_1", "blk_1.meta"):
        ref_bytes = (tmp_path / "ref" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == ref_bytes
        assert (tmp_path / "held" / name).read_bytes() == ref_bytes
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        ["blk_1", "blk_1.meta"]


BLOCK = 5 * 512 + 300  # a short last chunk
RANGES = [(0, None), (0, BLOCK), (100, 1000), (1500, 600), (2048, 512),
          (BLOCK - 10, 100), (BLOCK, None), (BLOCK + 5, 10), (0, 1)]


def _fault(store_dir: Path, fault: str) -> None:
    data, meta = store_dir / "blk_f", store_dir / "blk_f.meta"
    if fault == "flipped_byte":  # in chunk 2
        raw = bytearray(data.read_bytes())
        raw[1100] ^= 0x40
        data.write_bytes(bytes(raw))
    elif fault == "truncated_sidecar":
        meta.write_bytes(meta.read_bytes()[:-4])
    elif fault == "sidecar_magic":
        meta.write_bytes(b"XPUM" + meta.read_bytes()[4:])
    elif fault == "missing_sidecar":
        meta.unlink()
    elif fault == "missing_block":
        data.unlink()
        meta.unlink()


def _outcome(fn):
    try:
        return bytes(fn())
    except Exception as e:  # noqa: BLE001 - the class is the result
        return type(e).__name__


@pytest.mark.parametrize("into", [False, True], ids=["bytes", "into"])
@pytest.mark.parametrize("fault", ["none", "flipped_byte", "truncated_sidecar",
                                   "sidecar_magic", "chunk_size_mismatch",
                                   "missing_sidecar", "missing_block"])
def test_store_verified_read_matches_reference(tmp_path, fault, into):
    """``read_verified``, whole and partial, returns the reference store's
    bytes or raises its error class (by name) on each fault; ``into``
    lands the same bytes in the caller's buffer and returns it."""
    data = np.random.default_rng(3).bytes(BLOCK)
    blockstore.BlockStore(tmp_path).write("blk_f", data)
    _fault(tmp_path, fault)
    chunk = 1024 if fault == "chunk_size_mismatch" else 512
    port = blockstore.BlockStore(tmp_path, chunk_size=chunk)
    ref = ref_blockstore.BlockStore(tmp_path, chunk_size=chunk)
    sinks = []

    def sink(n):
        sinks.append(np.full(n, 0xAB, dtype=np.uint8))
        return sinks[-1]

    outcomes = set()
    for offset, length in RANGES:
        want = _outcome(lambda: ref.read_verified("blk_f", offset, length))
        got = _outcome(lambda: port.read_verified(
            "blk_f", offset, length, **({"into": sink} if into else {})))
        assert got == want, (offset, length)
        if into and isinstance(got, bytes):
            assert sinks[-1].tobytes() == got
        outcomes.add(want if isinstance(want, str) else "ok")
    if fault == "none":
        assert outcomes == {"ok"}
    else:
        assert outcomes - {"ok"} == {"BlockNotFoundError" if "missing" in fault
                                     else "BlockCorruptionError"}


def test_store_read_errors_are_the_ports_classes(tmp_path):
    port = blockstore.BlockStore(tmp_path)
    port.write("blk_f", b"x" * 2000)
    _fault(tmp_path, "flipped_byte")
    with pytest.raises(blockstore.BlockCorruptionError):
        port.read_verified("blk_f")
    with pytest.raises(blockstore.BlockNotFoundError):
        port.read_verified("blk_none")
    with pytest.raises(blockstore.BlockNotFoundError):
        port.read_verified("blk_none", 0, 100)


# -------------------------------------------------------------- counters


def _write(tmp_path):
    blockstore.BlockStore(tmp_path).write("blk_c", b"y" * 700)


def _read(tmp_path):
    store = blockstore.BlockStore(tmp_path)
    store.write("blk_c", b"y" * 700, checksum.crc32c_chunks_plain(b"y" * 700))
    store.read_verified("blk_c")


@pytest.mark.parametrize("entry,call", [
    ("crc32c", lambda tmp: checksum.crc32c(b"abc")),
    ("crc32c_chunks", lambda tmp: checksum.crc32c_chunks(b"abc")),
    ("crc64nvme", lambda tmp: checksum.crc64nvme(b"abc")),
    ("gf256_matmul", lambda tmp: erasure.encode(b"abcdef", 2, 1)),
    ("block_write", _write),
    ("block_read_verify", _read),
])
def test_each_native_entry_counts_its_calls(tmp_path, entry, call):
    before = native.call_counts()
    call(tmp_path)
    after = native.call_counts()
    assert after[entry] == before[entry] + 1
    native.reset_calls()
    assert set(native.call_counts().values()) == {0}


# ------------------------------------------------ no fallback, no build


@pytest.mark.parametrize("call", [
    lambda tmp: checksum.crc32c(b"abc"),
    lambda tmp: checksum.crc32c_chunks(b"abc"),
    lambda tmp: checksum.crc64nvme(b"abc"),
    lambda tmp: erasure.encode(b"abcdef", 2, 1),
    lambda tmp: blockstore.BlockStore(tmp).write("blk_x", b"abc"),
], ids=["crc32c", "crc32c_chunks", "crc64nvme", "encode", "store_write"])
def test_a_failed_build_raises_instead_of_running_numpy(monkeypatch, tmp_path,
                                                        call):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", [*native.SOURCES, bad])
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building the "
                                           "native host engine"):
        call(tmp_path)


def test_importing_the_port_builds_no_engine():
    code = """
import tpudfs_torch.gpu.write_group
import tpudfs_torch.chunkserver.blockstore
import tpudfs_torch.common.erasure
import tpudfs_torch.client.local
from tpudfs_torch.common import native
assert native._lib is None
print("unbuilt")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "unbuilt"


def test_engine_builds_every_source_into_the_ports_build_dir():
    assert [p.name for p in native.SOURCES] == ["blockio.cc", "crc32c.cc",
                                                "gf256.cc", "crc64.cc"]
    lib = native.lib()
    assert lib._name == str(native.library_path())
    assert native.library_path().parent == REPO / "build" / "tpudfs_torch"
    for symbol in ("tpudfs_gf256_matmul", "tpudfs_block_write",
                   "tpudfs_block_read_verify", "tpudfs_crc64nvme"):
        assert callable(getattr(lib, symbol))
