"""Port parity for the native sweep pump:
``HbmReader.sweep_paths_to_device`` of ``tpudfs_torch`` on the CPU device
against the JAX reference's, on the same files of an in-process
``MiniCluster`` through the same ``tpudfs.client.Client``. The pump
verifies on the host (fused pread + CRC32C in the producer thread): bytes,
``verified`` flags and ``sweep_blocks`` must agree exactly, and a corrupt
replica must fail its slot alone and be recovered by the per-block path."""

import jax
import pytest
import torch

from tests.test_torch_hbm_reader import _cluster, _corrupt_first_replica, _rand
from tpudfs.tpu import hbm_reader as ref
from tpudfs_torch.gpu import hbm_reader as port

CPU = torch.device("cpu")
BLOCK = 64 * 1024


def _file_bytes(blocks, metas, to_bytes):
    it = iter(blocks)
    return [b"".join(to_bytes(next(it).array, b["size"]) for b in m["blocks"])
            for m in metas]


async def test_sweep_pump_roundtrip(tmp_path):
    """Whole file sets come back bit-exact through a ring of 2 over 4
    rounds; the unaligned tail block and file fall back per block."""
    files = [(f"/sw/f{i}", _rand(3 * BLOCK, seed=60 + i)) for i in range(5)]
    files.append(("/sw/tail", _rand(BLOCK + 700, seed=70)))
    c, client = await _cluster(tmp_path, files, local_reads=True)
    try:
        reader = port.HbmReader(client, [CPU], batch_reads=8)
        blocks = await reader.sweep_paths_to_device(
            [p for p, _ in files], round_blocks=4, ring=2)
        assert all(b is not None and b.verified for b in blocks)
        await reader.confirm(blocks)
        metas = [await client.get_file_info(p) for p, _ in files]
        assert _file_bytes(blocks, metas, port.device_array_to_bytes) == \
            [d for _, d in files]
        assert reader.sweep_blocks == 16
    finally:
        await c.stop()


async def test_sweep_pump_corruption_falls_back_and_recovers(tmp_path):
    data = _rand(4 * BLOCK, seed=80)
    c, client = await _cluster(tmp_path, [("/sw/rot", data)],
                               local_reads=True)
    try:
        reader = port.HbmReader(client, [CPU], batch_reads=8)
        prime = await reader.sweep_paths_to_device(["/sw/rot"])
        await reader.confirm(prime)
        await _corrupt_first_replica(c, client, "/sw/rot")
        blocks = await reader.sweep_paths_to_device(["/sw/rot"])
        await reader.confirm(blocks)
        meta = await client.get_file_info("/sw/rot")
        assert _file_bytes(blocks, [meta], port.device_array_to_bytes) == [data]
        assert all(b.verified for b in blocks)
        assert reader.sweep_blocks == 4 + 3 and reader.rereads == 1
    finally:
        await c.stop()


@pytest.mark.parametrize("round_blocks,ring", [(4, 3), (3, 1)])
async def test_sweep_matches_reference(tmp_path, round_blocks, ring):
    """The same sweep through both packages, clean and then with a corrupt
    replica: bytes, verdicts, which blocks rode the pump, sweep_blocks."""
    files = [("/sm/a", _rand(5 * BLOCK, seed=81)),
             ("/sm/b", _rand(2 * BLOCK + 512 * 3, seed=82)),
             ("/sm/t", _rand(BLOCK + 99, seed=83))]
    c, client = await _cluster(tmp_path, files, local_reads=True)
    try:
        paths = [p for p, _ in files]
        ours = port.HbmReader(client, [CPU])
        theirs = ref.HbmReader(client, jax.devices()[:1])
        metas = [await client.get_file_info(p) for p in paths]
        for corrupt in (False, True):
            if corrupt:
                await _corrupt_first_replica(c, client, "/sm/b")
            before = (ours.sweep_blocks, theirs.sweep_blocks)
            mine = await ours.sweep_paths_to_device(
                paths, round_blocks=round_blocks, ring=ring)
            want = await theirs.sweep_paths_to_device(
                paths, round_blocks=round_blocks, ring=ring)
            assert [b.verified for b in mine] == [b.verified for b in want]
            assert all(b.verified for b in mine)
            assert [b.batch is None for b in mine] == \
                [b.batch is None for b in want]
            assert _file_bytes(mine, metas, port.device_array_to_bytes) == \
                _file_bytes(want, metas, ref.device_array_to_bytes) == \
                [d for _, d in files]
            served = (ours.sweep_blocks - before[0],
                      theirs.sweep_blocks - before[1])
            # 5 + 3 + 1 aligned blocks; the corrupt one falls back.
            assert served == ((8, 8) if corrupt else (9, 9))
    finally:
        await c.stop()
