"""Port parity for the read combiner (the batched read path):
``tpudfs_torch.gpu.read_combiner`` behind ``HbmReader(batch_reads=8)`` on
the CPU device, against the JAX reference's ``HbmReader(batch_reads=8)``,
both reading the same files through the same real ``tpudfs.client.Client``
on an in-process ``MiniCluster``. CRC is an exact integer function: bytes,
``verified`` flags, round and block counts and the resolved CRC vectors
must agree exactly, in both verify placements (``host_verify``: the CRC
inside the native pread, or on the device at ``confirm``). Also the port's
own binding of the native block I/O library against its plain twin."""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_hbm_reader import _cluster, _corrupt_first_replica, _rand
from tpudfs.tpu import hbm_reader as ref
from tpudfs_torch.common import native, trace
from tpudfs_torch.common.checksum import crc32c_plain
from tpudfs_torch.gpu import hbm_reader as port
from tpudfs_torch.gpu import u32_to_numpy
from tpudfs_torch.gpu.read_combiner import ReadCombiner

CPU = torch.device("cpu")
BLOCK = 64 * 1024


def _bytes(blocks) -> bytes:
    return b"".join(port.device_array_to_bytes(b.array, b.size)
                    for b in blocks)


def _ref_bytes(blocks) -> bytes:
    return b"".join(ref.device_array_to_bytes(b.array, b.size)
                    for b in blocks)


def _batched_reader(client, host_verify):
    client.local_reads = True  # conftest defaults TPUDFS_LOCAL_READS=0
    reader = port.HbmReader(client, [CPU], batch_reads=8)
    comb = reader._combiner(CPU)
    comb.host_verify = host_verify
    return reader, comb


async def _primed(reader, path):
    """Read once so the client's local-store probes are cached."""
    prime = await reader.read_file_to_device_blocks(path, verify="lazy")
    await reader.confirm(prime)


# ------------------------------------- mirrors of tests/test_tpu.py fused


@pytest.mark.parametrize("host_verify", [True, False])
async def test_fused_read_roundtrip(tmp_path, host_verify):
    data = _rand(6 * BLOCK, seed=50)
    c, client = await _cluster(tmp_path, [("/fu/a", data)])
    try:
        reader, comb = _batched_reader(client, host_verify)
        await _primed(reader, "/fu/a")
        blocks = await reader.read_file_to_device_blocks("/fu/a",
                                                         verify="lazy")
        assert comb.blocks >= 1, "combiner never engaged"
        await reader.confirm(blocks)
        assert all(b.verified for b in blocks)
        assert _bytes(blocks) == data
        await reader.confirm(blocks)  # idempotent
    finally:
        await c.stop()


async def test_fused_read_buffer_pool_reuse(tmp_path):
    d1 = _rand(4 * BLOCK, seed=53)
    d2 = _rand(4 * BLOCK, seed=54)
    c, client = await _cluster(tmp_path, [("/fu/p1", d1), ("/fu/p2", d2)])
    try:
        reader, comb = _batched_reader(client, True)
        for want, path in [(d1, "/fu/p1"), (d2, "/fu/p2")] * 3:
            blocks = await reader.read_file_to_device_blocks(path,
                                                             verify="lazy")
            await reader.confirm(blocks)
            assert _bytes(blocks) == want
        assert comb.blocks >= 6, "combiner never engaged"
        pooled = sum(len(v) for v in comb._buf_pool.values())
        assert 1 <= pooled <= comb._POOL_PER_SHAPE * len(comb._buf_pool), \
            comb._buf_pool
    finally:
        await c.stop()


async def test_fused_read_held_blocks_survive_buffer_recycle(tmp_path):
    d1 = _rand(4 * BLOCK, seed=57)
    d2 = _rand(4 * BLOCK, seed=58)
    c, client = await _cluster(tmp_path, [("/fu/h1", d1), ("/fu/h2", d2)])
    try:
        reader, comb = _batched_reader(client, True)
        held = await reader.read_file_to_device_blocks("/fu/h1",
                                                       verify="lazy")
        await reader.confirm(held)
        for _ in range(3):
            blocks = await reader.read_file_to_device_blocks("/fu/h2",
                                                             verify="lazy")
            await reader.confirm(blocks)
        assert comb.blocks >= 4, "combiner never engaged"
        assert _bytes(held) == d1, "recycled host buffer leaked into held blocks"
    finally:
        await c.stop()


async def test_fused_read_host_verify_falls_back_on_rot(tmp_path):
    data = _rand(4 * BLOCK, seed=51)
    c, client = await _cluster(tmp_path, [("/fu/rot", data)])
    try:
        reader, comb = _batched_reader(client, True)
        await _primed(reader, "/fu/rot")
        await _corrupt_first_replica(c, client, "/fu/rot")
        blocks = await reader.read_file_to_device_blocks("/fu/rot",
                                                         verify="lazy")
        await reader.confirm(blocks)
        assert all(b.verified for b in blocks)
        assert _bytes(blocks) == data
    finally:
        await c.stop()


async def test_fused_read_device_verify_confirm_recovers_rot(tmp_path):
    data = _rand(4 * BLOCK, seed=52)
    c, client = await _cluster(tmp_path, [("/fu/rot2", data)])
    try:
        reader, comb = _batched_reader(client, False)
        await _primed(reader, "/fu/rot2")
        await _corrupt_first_replica(c, client, "/fu/rot2")
        blocks = await reader.read_file_to_device_blocks("/fu/rot2",
                                                         verify="lazy")
        assert any(b.batch_pending for b in blocks)
        await reader.confirm(blocks)
        assert all(b.verified for b in blocks)
        assert _bytes(blocks) == data
    finally:
        await c.stop()


async def test_fused_read_mixed_block_sizes(tmp_path):
    data = _rand(2 * BLOCK + 777, seed=53)
    c, client = await _cluster(tmp_path, [("/fu/mix", data)])
    try:
        reader, comb = _batched_reader(client, True)
        await _primed(reader, "/fu/mix")
        blocks = await reader.read_meta_blocks_fast(
            await client.get_file_info("/fu/mix"), reader.devices[0])
        await reader.confirm(blocks)
        assert all(b.verified for b in blocks)
        assert _bytes(blocks) == data
        assert [b.batch is not None for b in blocks] == [True, True, False]
    finally:
        await c.stop()


async def test_fused_round_copies_are_counted_uploads(tmp_path):
    """A round's copy goes through ``reused_to_device``, as every upload
    of the read path: one ``reader.h2d`` span a round, inside its
    ``combiner.upload``, and the round's bytes in ``h2d.pageable_bytes``
    (the CPU device's round buffers are not pinned)."""
    data = _rand(8 * BLOCK, seed=62)
    c, client = await _cluster(tmp_path, [("/fu/h2d", data)])
    try:
        reader, comb = _batched_reader(client, True)
        await _primed(reader, "/fu/h2d")
        rounds = comb.rounds
        counted = trace.counts()
        spans, installed = [], trace._sink
        trace.install(SimpleNamespace(add=lambda *span: spans.append(span)))
        try:
            blocks = await reader.read_file_to_device_blocks("/fu/h2d",
                                                             verify="lazy")
        finally:
            trace.install(installed)
        now = trace.counts()
        assert all(b.batch is not None for b in blocks)
        assert comb.rounds > rounds
        uploads = {s[4] for s in spans if s[0] == "combiner.upload"}
        copies = [s for s in spans if s[0] == "reader.h2d"]
        assert len(copies) == len(uploads) == comb.rounds - rounds
        assert all(s[5] in uploads for s in copies)
        assert sum(s[3] for s in copies) == len(data)
        moved = {k: now.get(k, 0) - counted.get(k, 0)
                 for k in ("h2d.pageable_bytes", "h2d.pinned_bytes")}
        assert moved == {"h2d.pageable_bytes": len(data),
                         "h2d.pinned_bytes": 0}
        await reader.confirm(blocks)
        assert _bytes(blocks) == data
    finally:
        await c.stop()


async def test_fused_read_sync_arrays_no_slices(tmp_path):
    data = _rand(4 * BLOCK, seed=54)
    c, client = await _cluster(tmp_path, [("/fu/sync", data)])
    try:
        reader, comb = _batched_reader(client, True)
        await _primed(reader, "/fu/sync")
        blocks = await reader.read_file_to_device_blocks("/fu/sync",
                                                         verify="lazy")
        fused = [b for b in blocks if b.batch is not None]
        assert fused
        for b in fused:
            for arr in b.sync_arrays:
                assert arr.shape[0] >= b.batch.cpb  # batch-level, not slice
            assert b._array is None  # nothing sliced yet
        await reader.confirm(blocks)
        assert _bytes(blocks) == data
    finally:
        await c.stop()


@pytest.mark.parametrize("host_verify", [True, False])
async def test_fused_read_remote_rounds(tmp_path, host_verify):
    data = _rand(6 * BLOCK, seed=60)
    c, client = await _cluster(tmp_path, [("/rf/a", data)])
    try:
        client.local_reads = False
        reader = port.HbmReader(client, [CPU], batch_reads=8)
        comb = reader._combiner(CPU)
        comb.host_verify = host_verify
        blocks = await reader.read_file_to_device_blocks("/rf/a",
                                                         verify="lazy")
        assert comb.blocks >= 1, "remote fused rounds never engaged"
        await reader.confirm(blocks)
        assert all(b.verified for b in blocks)
        assert _bytes(blocks) == data
    finally:
        await c.stop()


async def test_fused_read_remote_corrupt_slot_falls_back(tmp_path):
    data = _rand(4 * BLOCK, seed=61)
    c, client = await _cluster(tmp_path, [("/rf/rot", data)])
    try:
        client.local_reads = False
        await _corrupt_first_replica(c, client, "/rf/rot")
        reader = port.HbmReader(client, [CPU], batch_reads=8)
        blocks = await reader.read_file_to_device_blocks("/rf/rot",
                                                         verify="lazy")
        await reader.confirm(blocks)
        assert all(b.verified for b in blocks)
        assert _bytes(blocks) == data
    finally:
        await c.stop()


# ------------------------------------------------ against the JAX reader


def _ref_reader(client, host_verify):
    reader = ref.HbmReader(client, jax.devices()[:1], batch_reads=8)
    reader._combiner(reader.devices[0]).host_verify = host_verify
    return reader


def _pending_crcs(blocks, to_numpy):
    """Per block: its round's (n,) CRC vector as a list (None when the
    round was verified on the host)."""
    return [None if b.batch is None or b.batch.crcs is None
            else [int(x) for x in to_numpy(b.batch.crcs)] for b in blocks]


@pytest.mark.parametrize("host_verify", [True, False])
async def test_combiner_matches_reference(tmp_path, host_verify):
    """Six blocks (rounds of 4 + 2), three full blocks and a short aligned
    one (a second chunk-count group), and an unaligned tail file: the same
    rounds, blocks, CRC vectors, verdicts and bytes as the reference."""
    files = [("/pa/six", _rand(6 * BLOCK, seed=90)),
             ("/pa/short", _rand(3 * BLOCK + 5 * 512, seed=91)),
             ("/pa/tail", _rand(BLOCK + 700, seed=92))]
    c, client = await _cluster(tmp_path, files, local_reads=True)
    try:
        ours, _ = _batched_reader(client, host_verify)
        theirs = _ref_reader(client, host_verify)
        for path, _ in files:
            await _primed(ours, path)
        mine_comb = ours._combiner(CPU)
        their_comb = theirs._combiner(theirs.devices[0])
        mine_comb.rounds = mine_comb.blocks = 0
        for path, data in files:
            mine = await ours.read_file_to_device_blocks(path, verify="lazy")
            want = await theirs.read_file_to_device_blocks(path,
                                                           verify="lazy")
            assert [b.batch_pending for b in mine] == \
                [b.batch_pending for b in want]
            assert _pending_crcs(mine, u32_to_numpy) == \
                _pending_crcs(want, np.asarray)
            await ours.confirm(mine)
            await theirs.confirm(want)
            assert [b.verified for b in mine] == [b.verified for b in want]
            assert all(b.verified for b in mine)
            assert [None if b.batch is None or b.batch.resolved is None
                    else list(b.batch.resolved) for b in mine] == \
                [None if b.batch is None or b.batch.resolved is None
                 else list(b.batch.resolved) for b in want]
            assert _bytes(mine) == _ref_bytes(want) == data
            assert (mine_comb.rounds, mine_comb.blocks) == \
                (their_comb.rounds, their_comb.blocks)
        # six: 4 + 2; short: 3 full + 1 short block (its own group); tail:
        # 1 full, the unaligned block takes the per-block path.
        assert (mine_comb.rounds, mine_comb.blocks) == (6, 11)
    finally:
        await c.stop()


@pytest.mark.parametrize("host_verify", [True, False])
async def test_combiner_rot_recovery_matches_reference(tmp_path, host_verify):
    """A corrupt first replica: host-verified rounds send the block to the
    per-block path, device-verified ones flag it at confirm and re-read it;
    both packages serve the same verified bytes with the same counts."""
    data = _rand(4 * BLOCK, seed=93)
    c, client = await _cluster(tmp_path, [("/pa/rot", data)],
                               local_reads=True)
    try:
        ours, mine_comb = _batched_reader(client, host_verify)
        theirs = _ref_reader(client, host_verify)
        their_comb = theirs._combiner(theirs.devices[0])
        await _primed(ours, "/pa/rot")
        mine_comb.rounds = mine_comb.blocks = 0
        await _corrupt_first_replica(c, client, "/pa/rot")
        mine = await ours.read_file_to_device_blocks("/pa/rot", verify="lazy")
        want = await theirs.read_file_to_device_blocks("/pa/rot",
                                                       verify="lazy")
        await ours.confirm(mine)
        await theirs.confirm(want)
        assert [b.verified for b in mine] == [b.verified for b in want]
        assert all(b.verified for b in mine)
        assert _bytes(mine) == _ref_bytes(want) == data
        assert (mine_comb.rounds, mine_comb.blocks) == \
            (their_comb.rounds, their_comb.blocks) == \
            ((2, 3) if host_verify else (1, 4))
        # Either way the bad replica is flagged by a device fold (the
        # per-block fallback also reads it unverified) and re-read once.
        assert ours.rereads == 1
    finally:
        await c.stop()


# ------------------------------------------- pool buffers on the CPU device


async def test_combiner_pool_buffers_are_not_aliased_on_cpu(tmp_path):
    """On the CPU device ``.to("cpu")`` hands back the very buffer, so a
    held block would alias pooled memory that the next round refills. The
    combiner clones each round out of the pool: round 1's blocks are held
    while the SAME pooled buffer is refilled with other bytes, then read
    back."""
    rows = torch.zeros((4, 128), dtype=torch.int32)
    assert rows.to(CPU) is rows  # what the clone defends against
    d1 = _rand(4 * BLOCK, seed=94)
    d2 = _rand(4 * BLOCK, seed=95)
    c, client = await _cluster(tmp_path, [("/al/a", d1), ("/al/b", d2)],
                               local_reads=True)
    try:
        reader, comb = _batched_reader(client, True)
        await _primed(reader, "/al/a")
        await _primed(reader, "/al/b")
        held = await reader.read_file_to_device_blocks("/al/a", verify="lazy")
        (buf,) = comb._buf_pool[4 * (BLOCK // 512)]
        for _ in range(2):
            blocks = await reader.read_file_to_device_blocks("/al/b",
                                                             verify="lazy")
            pool = comb._buf_pool[4 * (BLOCK // 512)]
            assert [id(x) for x in pool] == [id(buf)]  # recycled
        lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel() * 4
        for b in held + blocks:
            assert not lo <= b.array.data_ptr() < hi
        assert buf.view(torch.uint8).reshape(-1).numpy().tobytes() == d2
        assert _bytes(held) == d1
        assert _bytes(blocks) == d2
    finally:
        await c.stop()


def test_combiner_defaults(tmp_path):
    comb = ReadCombiner(None, CPU)
    assert comb.device == CPU and comb.host_verify is True
    buf = comb._alloc_round_buf(8)
    assert buf.shape == (8, 128) and buf.dtype == torch.uint32
    assert not buf.is_pinned()
    comb.warm(8)
    assert sorted(comb._buf_pool) == [8 * b for b in (1, 2, 4, 8, 16, 32)]


# ------------------------------------------------ native block I/O binding


def test_native_fill_matches_plain_fill_and_crc32c(tmp_path):
    """The native batched pread (with and without its fused CRC), the
    plain Python fill and ``checksum.crc32c_plain`` agree on sizes, bytes and
    CRCs: a full slot, a short file, an empty file, a missing file and a
    file longer than the slot."""
    stride = 8 * 512
    rng = np.random.default_rng(7)
    contents = {"full": rng.bytes(stride), "short": rng.bytes(1000),
                "empty": b"", "long": rng.bytes(stride + 99)}
    paths = []
    for name, data in contents.items():
        (tmp_path / name).write_bytes(data)
        paths.append(str(tmp_path / name))
    paths.insert(2, str(tmp_path / "missing"))
    n = len(paths)
    native_buf = np.zeros(n * stride, dtype=np.uint8)
    plain_buf = np.zeros(n * stride, dtype=np.uint8)
    sizes, crcs = native.blocks_read(paths, stride, native_buf.ctypes.data,
                                     with_crc=True)
    psizes, pcrcs = native.blocks_read_plain(paths, stride, plain_buf,
                                             with_crc=True)
    bare_buf = np.zeros_like(native_buf)
    nsizes, none = native.blocks_read(paths, stride, bare_buf.ctypes.data,
                                      with_crc=False)
    assert none is None
    want = [stride, 1000, -2, 0, stride]  # -ENOENT for the missing file
    assert list(sizes) == list(psizes) == list(nsizes) == want
    np.testing.assert_array_equal(crcs, pcrcs)
    np.testing.assert_array_equal(native_buf, plain_buf)
    np.testing.assert_array_equal(bare_buf, plain_buf)
    for i, name in enumerate(["full", "short", None, "empty", "long"]):
        data = contents[name][:stride] if name else b""
        assert int(crcs[i]) == crc32c_plain(data)
        assert native_buf[i * stride : i * stride + len(data)].tobytes() == data


def test_native_library_is_the_ports_own_build():
    so = native.library_path()
    assert so.parent == native.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "tpudfs_torch")
    lib = native.lib()
    assert lib._name == str(so) and os.path.exists(so)
    assert "libtpudfs_native" not in lib._name
    for symbol in ("tpudfs_sweep_start", "tpudfs_sweep_wait"):
        assert getattr(lib, symbol).restype is native.ctypes.c_int64
    assert native.lib() is lib
