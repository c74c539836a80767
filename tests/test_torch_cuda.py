"""The port's hand-written CUDA kernels against their plain PyTorch twins,
on the card. Each test takes the ``cuda_device`` fixture and skips, with
its reason, on a host without a card: a CUDA kernel has no CPU or
interpret mode. This file imports neither jax nor ``tpudfs``, so it also
runs on a card host that has no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import asyncio

import numpy as np
import pytest
import torch

from tpudfs_torch.client.local import DfsError, LocalClient
from tpudfs_torch.gpu import host_to_device, u32_to_numpy
from tpudfs_torch.gpu import crc32c_cuda, rs_cuda
from tpudfs_torch.gpu.hbm_reader import HbmReader, device_array_to_bytes
from torch_ring import shard

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, shape, dtype=np.uint32)


@pytest.mark.parametrize("c", [1, 255, 257, 4096])
def test_crc_kernel_matches_plain(cuda_device, c):
    words = _words((c, 128), c)
    before = crc32c_cuda.crc32c_chunks_device.launches
    got = crc32c_cuda.crc32c_chunks_device(host_to_device(words, cuda_device))
    want = crc32c_cuda.crc32c_chunks_device(host_to_device(words, CPU))
    np.testing.assert_array_equal(u32_to_numpy(got), u32_to_numpy(want))
    assert crc32c_cuda.crc32c_chunks_device.launches == before + 1


def test_crc_kernel_empty_and_block_fold(cuda_device):
    empty = torch.zeros((0, 128), dtype=torch.int32, device=cuda_device)
    assert crc32c_cuda.crc32c_chunks_device(empty.view(torch.uint32)).numel() == 0
    data = np.random.default_rng(3).integers(0, 256, 64 * 1024, dtype=np.uint8)
    words = host_to_device(crc32c_cuda.bytes_to_words(data), cuda_device)
    on_card = crc32c_cuda.block_crc_device(words)
    on_cpu = crc32c_cuda.block_crc_device(words.cpu())
    assert u32_to_numpy(on_card.reshape(1)) == u32_to_numpy(on_cpu.reshape(1))


def test_crc_kernel_rejects_strided_input(cuda_device):
    words = host_to_device(_words((8, 256), 1), cuda_device)[:, :128]
    with pytest.raises(ValueError, match="contiguous"):
        crc32c_cuda.crc32c_chunks_device(words)
    with pytest.raises(ValueError, match="contiguous"):
        crc32c_cuda.crc32c_blocks_device(words, 2)
    flat = host_to_device(_words((9 * 128,), 2), cuda_device)
    misaligned = flat[1 : 1 + 8 * 128].view(8, 128)  # 4 bytes past 16
    for fn in (crc32c_cuda.crc32c_chunks_device,
               crc32c_cuda.block_crc_device):
        with pytest.raises(ValueError, match="aligned"):
            fn(misaligned)


def _blocks_plain(words: np.ndarray, nblocks: int, fold=None) -> np.ndarray:
    cpu = host_to_device(words, CPU)
    return u32_to_numpy(crc32c_cuda.crc32c_blocks_device(
        cpu, nblocks, fold=None if fold is None else fold.cpu()))


@pytest.mark.parametrize("nblocks", [1, 3, 16])
@pytest.mark.parametrize("cpb", [1, 255, 257, 4096])
def test_fused_block_kernel_matches_plain(cuda_device, cpb, nblocks):
    words = _words((nblocks * cpb, 128), cpb * 31 + nblocks)
    on_card = host_to_device(words, cuda_device)
    before = crc32c_cuda.crc32c_blocks_device.launches
    chunks_before = crc32c_cuda.crc32c_chunks_device.launches
    got = u32_to_numpy(crc32c_cuda.batch_block_crc_device(on_card, nblocks))
    assert crc32c_cuda.crc32c_blocks_device.launches == before + 1
    assert crc32c_cuda.crc32c_chunks_device.launches == chunks_before
    np.testing.assert_array_equal(got, _blocks_plain(words, nblocks))
    # Two runs give the same words, whatever order the atomics landed in.
    again = u32_to_numpy(crc32c_cuda.batch_block_crc_device(on_card, nblocks))
    np.testing.assert_array_equal(again, got)


def test_fused_block_kernel_overrides_drive_the_result(cuda_device):
    from tpudfs_torch.gpu import state

    cpb = 257
    keys = ["word_contrib_table", "inv_contrib", f"combine_fold_table/{cpb}"]
    tables = state.own_tables(keys, cuda_device)
    words = _words((3 * cpb, 128), 77)
    on_card = host_to_device(words, cuda_device)
    fold = tables[f"combine_fold_table/{cpb}"]
    want = _blocks_plain(words, 3)
    got = crc32c_cuda.crc32c_blocks_device(
        on_card, 3, wcontrib=tables["word_contrib_table"],
        inv=tables["inv_contrib"], fold=fold)
    np.testing.assert_array_equal(u32_to_numpy(got), want)
    np.testing.assert_array_equal(u32_to_numpy(
        crc32c_cuda.batch_block_crc_device(on_card, 3, fold=fold)), want)
    one = host_to_device(words[:cpb], cuda_device)
    before = crc32c_cuda.crc32c_blocks_device.launches
    block = crc32c_cuda.block_crc_device(one, fold=fold)
    assert crc32c_cuda.crc32c_blocks_device.launches == before + 1
    assert u32_to_numpy(block.reshape(1))[0] == want[0]
    # A changed fold table changes the result: the kernel reads it.
    other = fold.clone()
    other[cpb - 2] = other[cpb - 1]  # M^1 replaced by the identity
    assert u32_to_numpy(crc32c_cuda.block_crc_device(one, fold=other)
                        .reshape(1))[0] != want[0]


def _gf_on_card_and_cpu(words: np.ndarray, bits: np.ndarray, device):
    got = rs_cuda.gf_matmul_words(host_to_device(words, device),
                                  host_to_device(bits, device))
    want = rs_cuda.gf_matmul_words(host_to_device(words, CPU),
                                   host_to_device(bits, CPU))
    return u32_to_numpy(got), u32_to_numpy(want)


@pytest.mark.parametrize("w", [32, 2047, 65536])
def test_gf_kernel_matches_plain(cuda_device, w):
    """RS(6,3) encode and decode, and a random matrix of every shape with
    1 <= rows, cols <= 10 (1 to 3 row groups, 4-word and 1-word paths)."""
    rng = np.random.default_rng(w)
    words = _words((10, w), w)
    cases = [rs_cuda.coef_bits(6, 3),
             rs_cuda._matrix_bits(rs_cuda.decode_matrix(
                 6, 3, (1, 3, 4, 5, 6, 8)))]
    cases += [rs_cuda._matrix_bits(rng.integers(0, 256, (rows, cols),
                                                dtype=np.uint8))
              for rows in range(1, 11) for cols in range(1, 11)]
    for bits in cases:
        got, want = _gf_on_card_and_cpu(words[: bits.shape[1]], bits,
                                        cuda_device)
        np.testing.assert_array_equal(got, want, err_msg=str(bits.shape))


@pytest.mark.parametrize("rows,cols", [(16, 16), (17, 3), (33, 2), (20, 76),
                                       (1, 1536)])
def test_gf_kernel_large_shapes(cuda_device, rows, cols):
    """More than 16 rows (the input read again per 16), and tables above
    48 KiB of shared memory (the kernel opts into more)."""
    mat = np.random.default_rng(rows + cols).integers(0, 256, (rows, cols),
                                                      dtype=np.uint8)
    got, want = _gf_on_card_and_cpu(_words((cols, 4096), cols),
                                    rs_cuda._matrix_bits(mat), cuda_device)
    np.testing.assert_array_equal(got, want)


def test_gf_kernel_one_word_path_and_determinism(cuda_device):
    """A word view 4 bytes past 16-byte alignment takes the one-word path;
    it and the aligned 4-word path give the plain twin's words, twice."""
    bits = host_to_device(rs_cuda._matrix_bits(rs_cuda.decode_matrix(
        6, 3, (1, 3, 4, 5, 6, 8))), cuda_device)
    w = 4096
    flat = host_to_device(_words((6 * w + 1,), 11), cuda_device)
    misaligned = flat[1 : 1 + 6 * w].view(6, w)
    assert misaligned.data_ptr() % 16 == 4
    aligned = misaligned.clone()
    want = u32_to_numpy(rs_cuda.gf_matmul_words(misaligned.cpu(), bits.cpu()))
    before = rs_cuda.gf_matmul_words.launches
    for words in (misaligned, aligned, misaligned, aligned):
        np.testing.assert_array_equal(
            u32_to_numpy(rs_cuda.gf_matmul_words(words, bits)), want)
    assert rs_cuda.gf_matmul_words.launches == before + 4


def test_rs_encode_on_card_matches_cpu(cuda_device):
    data = np.random.default_rng(5).integers(0, 256, 100_000, dtype=np.uint8)
    assert rs_cuda.rs_encode_torch(data.tobytes(), 6, 3, cuda_device) == \
        rs_cuda.rs_encode_torch(data.tobytes(), 6, 3, CPU)


def test_read_path_on_card_launches_both_kernels(cuda_device, tmp_path):
    import chip_smoke

    r = chip_smoke.read_path(cuda_device, workdir=tmp_path,
                             block_size=1 << 20, nblocks=3, tail_size=70_001)
    assert r["tamper"]["recovered"]
    assert r["launches"]["crc32c_chunks"] > 0
    assert r["launches"]["crc32c_blocks"] > 0
    assert r["launches"]["gf256_matmul"] > 0


def test_device_array_to_bytes_round_trip(cuda_device):
    data = np.random.default_rng(9).integers(0, 256, 5000, dtype=np.uint8)
    words = host_to_device(crc32c_cuda.bytes_to_words(data), cuda_device)
    assert device_array_to_bytes(words, 5000) == data.tobytes()


# ------------------------------------------------------- batched read paths


def _layout(tmp_path, nblocks=6):
    """Six 64 KiB blocks at 3x replication plus an unaligned tail file, in
    the chunkserver's format (``chip_smoke.lay_out``)."""
    import chip_smoke

    stores, metas, sources = chip_smoke.lay_out(
        tmp_path, np.random.default_rng(3), block_size=64 * 1024,
        nblocks=nblocks, tail_size=20_003, ec=(6, 3), lost=(0, 2, 7))
    return LocalClient(stores, metas), metas, sources


def _bytes(blocks) -> bytes:
    return b"".join(device_array_to_bytes(b.array, b.size) for b in blocks)


def test_combiner_held_blocks_survive_pinned_recycling(cuda_device, tmp_path):
    """Blocks of the first pass are held while three more passes (reverse
    order, rounds of 2) refill the recycled pinned buffers with other
    blocks' bytes; every pass verifies on the card and reads back exact."""
    client, metas, sources = _layout(tmp_path)
    meta = metas["/smoke/big"]
    reader = HbmReader(client, [cuda_device], batch_reads=2)

    async def run():
        held = await reader.read_file_to_device_blocks("/smoke/big",
                                                       verify="lazy")
        await reader.confirm(held)
        for _ in range(3):
            again = await reader.read_meta_blocks_fast(
                {**meta, "blocks": meta["blocks"][::-1]}, cuda_device)
            await reader.confirm(again)
        return held, again[::-1]

    held, again = asyncio.run(run())
    comb = reader._combiner(cuda_device)
    assert not comb.host_verify and comb.blocks == 24 and comb.rounds == 12
    pooled = [b for bufs in comb._buf_pool.values() for b in bufs]
    assert pooled and all(b.is_pinned() for b in pooled)
    assert all(b.verified for b in held + again) and reader.rereads == 0
    assert all(b.array.device == cuda_device for b in held)
    data = sources["/smoke/big"].tobytes()
    assert _bytes(held) == data and _bytes(again) == data


def test_combiner_device_verdicts_match_cpu(cuda_device, tmp_path):
    """With one replica tampered, the card's fused CRC vectors and verdicts
    equal the CPU device's (plain twin, also verifying on the device)."""
    import chip_smoke

    client, metas, sources = _layout(tmp_path)
    chip_smoke._flip_first_replica(client, metas["/smoke/big"]["blocks"][1])

    async def verdicts(device):
        reader = HbmReader(client, [device], batch_reads=4)
        reader._combiner(device).host_verify = False
        blocks = await reader.read_file_to_device_blocks("/smoke/big",
                                                         verify="lazy")
        with pytest.raises(DfsError, match="blk_smoke_big_1"):
            await reader.confirm(blocks, retry=False)
        return ([b.verified for b in blocks],
                [int(b.batch.resolved[b.batch_index]) for b in blocks])

    on_card = asyncio.run(verdicts(cuda_device))
    assert on_card == asyncio.run(verdicts(CPU))
    assert on_card[0] == [True, False, True, True, True, True]


def test_sweep_on_card_bit_exact(cuda_device, tmp_path):
    client, metas, sources = _layout(tmp_path)
    reader = HbmReader(client, [cuda_device])
    got = asyncio.run(reader.sweep_paths_to_device(
        ["/smoke/big", "/smoke/tail"], round_blocks=2, ring=2))
    assert reader.sweep_blocks == 6  # the unaligned tail falls back
    assert all(b.verified and b.array.device == cuda_device for b in got)
    assert _bytes(got[:6]) == sources["/smoke/big"].tobytes()
    assert _bytes(got[6:]) == sources["/smoke/tail"].tobytes()


# ------------------------------------------------------------- write side


def _ring_inputs(n: int, chunks: int, seed: int):
    from tpudfs_torch.common import native

    data = np.random.default_rng(seed).integers(0, 256, n * chunks * 512,
                                                dtype=np.uint8)
    return crc32c_cuda.bytes_to_words(data), native.crc32c_chunks(data)


def _on(parts):
    return [u32_to_numpy(p) for p in parts]


def test_native_chunk_crc_binding_equals_numpy():
    """The port's binding of the native ``tpudfs_crc32c_chunks`` (the write
    group's staging CRC) against the numpy ``crc32c_chunks``, short last
    chunks included. Needs no card."""
    from tpudfs_torch.common import checksum, native

    rng = np.random.default_rng(12)
    for n in (0, 1, 511, 512, 513, 4096 * 3 + 17, 1 << 20):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        want = checksum.crc32c_chunks(data)
        np.testing.assert_array_equal(native.crc32c_chunks(data), want)
        np.testing.assert_array_equal(native.crc32c_chunks(data.tobytes()), want)
    np.testing.assert_array_equal(
        native.crc32c_chunks(data, 4096), checksum.crc32c_chunks(data, 4096))


@pytest.mark.parametrize("n,poison", [(3, False), (4, True)])
def test_replicator_on_card_matches_cpu(cuda_device, n, poison):
    from tpudfs_torch.gpu import ici_replication as ici

    words, crcs = _ring_inputs(n, 257, seed=n)
    if poison:
        crcs[257] ^= 0xDEADBEEF  # position 1's first chunk
    out = {}
    for dev in (cuda_device, CPU):
        mesh = ici.make_mesh([dev] * n)
        before = crc32c_cuda.crc32c_chunks_device.launches
        replicas, ok, acks = ici.IciReplicator(mesh, 3).replicate(
            shard(words, mesh), shard(crcs, mesh))
        if dev.type == "cuda":
            assert crc32c_cuda.crc32c_chunks_device.launches == before + n
            assert acks.device == cuda_device
            assert all(r.device == cuda_device for r in replicas)
        out[dev.type] = (_on(replicas), [bool(o) for o in ok], int(acks))
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_array_equal(a, b)
    assert out["cuda"][1:] == out["cpu"][1:]
    assert out["cuda"][2] == (1 if poison else n)


def test_scatter_and_gather_on_card_match_cpu(cuda_device):
    """RS(6,3) over 9 positions on one card: the shards, ok bits and acks
    of the scatter, then the gather around position 4 with its rows
    garbage, equal the CPU run; one encode and two CRC launches a position
    in the scatter, one decode a position in the gather."""
    from tpudfs_torch.gpu import ici_replication as ici

    k, m, n = 6, 3, 9
    words, _ = _ring_inputs(n, 100, seed=9)
    out = {}
    for dev in (cuda_device, CPU):
        mesh = ici.make_mesh([dev] * n)
        crc0 = crc32c_cuda.crc32c_chunks_device.launches
        gf0 = rs_cuda.gf_matmul_words.launches
        shards, ok, acks = ici.EcShardScatter(mesh, k, m).scatter(
            shard(words, mesh))
        shards[4].view(torch.int32).fill_(0x25A5A5A5)
        recon = ici.EcShardGather(mesh, k, m).gather(shards, failed=4)
        if dev.type == "cuda":
            assert crc32c_cuda.crc32c_chunks_device.launches == crc0 + 2 * n
            assert rs_cuda.gf_matmul_words.launches == gf0 + 2 * n
        out[dev.type] = (_on(shards), _on(recon), [bool(o) for o in ok],
                         int(acks))
    for i in (0, 1):
        for a, b in zip(out["cuda"][i], out["cpu"][i]):
            np.testing.assert_array_equal(a, b)
    assert out["cuda"][2:] == out["cpu"][2:] == ([True] * n, n)
    recon = np.stack(out["cuda"][1]).reshape(n, -1)
    np.testing.assert_array_equal(recon[:, : 100 * 128],
                                  words.reshape(n, -1))


def test_gather_runtime_decode_matrix_launch_matches_plain(cuda_device):
    """The gather's (6, 9) decode-and-select matrices (zero column
    included) through the kernel, for every position, against the plain
    twin."""
    from tpudfs_torch.gpu import ici_replication as ici

    rows = _words((9, 4096), 5)
    for mat in ici.decode_select_matrices(6, 3, 9, 9, 4):
        got, want = _gf_on_card_and_cpu(rows, rs_cuda._matrix_bits(mat),
                                        cuda_device)
        np.testing.assert_array_equal(got, want)


def test_write_side_on_card_launches_its_kernels(cuda_device, tmp_path):
    import chip_smoke

    w = chip_smoke.write_path(cuda_device, workdir=tmp_path,
                              block_size=1 << 20, nblocks=2)
    assert w["acks"] == 3 and w["tamper"]["persisted"] == 0
    assert w["launches"]["crc32c_chunks"] > 0
    ec = chip_smoke.ec_collective(cuda_device, block_size=1 << 20)
    assert ec["exact"] and ec["write_step"]["parity_exact"]
    assert ec["launches"]["crc32c_chunks"] > 0
    assert ec["launches"]["gf256_matmul"] > 0
    # 9 scatter encodes + 3 write-step parities; 2 gathers x 9 decodes.
    assert ec["gf256_launches"] == {"encode": 12, "decode": 18}


def test_ring_across_cards_matches_cpu(cuda_device):
    """Positions on distinct cards (every hop a peer copy, every launch on
    its position's card): the chain, the RS(2,2) scatter and the gather
    around position 1 equal the same ring on CPU positions."""
    from tpudfs_torch.gpu import ici_replication as ici

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    n = min(n, 4)
    cards = [torch.device("cuda", i) for i in range(n)]
    words, crcs = _ring_inputs(n, 64, seed=40 + n)
    k, m = max(1, n - 2), min(2, n - 1)
    out = {}
    for devs in (cards, [CPU] * n):
        mesh = ici.make_mesh(devs)
        replicas, ok, acks = ici.IciReplicator(mesh, min(3, n)).replicate(
            shard(words, mesh), shard(crcs, mesh))
        shards, sok, sacks = ici.EcShardScatter(mesh, k, m).scatter(
            shard(words, mesh))
        shards[1].view(torch.int32).fill_(-1)
        recon = ici.EcShardGather(mesh, k, m).gather(shards, failed=1)
        if devs is cards:
            assert [r.device for r in replicas + shards + recon] == cards * 3
        out[devs[0].type] = (_on(replicas), _on(shards), _on(recon),
                             [bool(o) for o in ok + sok], int(acks), int(sacks))
    for i in range(3):
        for a, b in zip(out["cuda"][i], out["cpu"][i]):
            np.testing.assert_array_equal(a, b)
    assert out["cuda"][3:] == out["cpu"][3:] == ([True] * (2 * n), n, n)


# ------------------------------------------------------ checkpoint restore


def _shard_layout(tmp_path, seed: int):
    """A small checkpoint shard (``chip_smoke.ckpt_state``: three fp32
    states, an int64 step, an int8 tail) laid out as the manager saves it
    (3x hot copy + RS(3,2) cold copy) in 64 KiB blocks; (client, spec, tree
    on the CPU, metas)."""
    import chip_smoke
    from tpudfs_torch.common.checksum import crc32c
    from tpudfs_torch.gpu.checkpoint import pack_shard

    tree = chip_smoke.ckpt_state(30_011, seed, CPU)
    payload, specs = pack_shard(tree)
    stores, metas = chip_smoke.lay_out_shard(
        tmp_path, np.frombuffer(payload, dtype=np.uint8),
        block_size=64 * 1024, hot="/c/hot", cold="/c/ec")
    spec = {"shard": 0, "path": "/c/hot", "ec_path": "/c/ec",
            "size": len(payload), "crc32c": crc32c(payload),
            "tensors": [t.to_dict() for t in specs]}
    return LocalClient(stores, metas), spec, tree, metas


def _restore(client, spec, device):
    from tpudfs_torch.gpu.checkpoint import restore_shard_device

    stats = {"degraded_shard_reads": 0}
    out = asyncio.run(restore_shard_device(
        HbmReader(client, [device]), client, spec, device, stats))
    return out, stats["degraded_shard_reads"]


@pytest.mark.parametrize("degraded", [False, True])
def test_restore_shard_device_on_card_matches_cpu(cuda_device, tmp_path,
                                                  degraded):
    import chip_smoke

    client, spec, tree, metas = _shard_layout(tmp_path, seed=61)
    if degraded:
        block = metas["/c/hot"]["blocks"][2]
        for replica in range(3):
            chip_smoke._flip_first_replica(client, block, replica)
        chip_smoke._drop_shards(client, metas["/c/ec"], (0, 3))
    before = {k: w.launches for k, w in (
        ("blocks", crc32c_cuda.crc32c_blocks_device),
        ("chunks", crc32c_cuda.crc32c_chunks_device),
        ("gf", rs_cuda.gf_matmul_words))}
    on_card, card_degraded = _restore(client, spec, cuda_device)
    on_cpu, cpu_degraded = _restore(client, spec, CPU)
    assert card_degraded == cpu_degraded == int(degraded)
    nblocks = len(metas["/c/hot"]["blocks"])
    assert crc32c_cuda.crc32c_blocks_device.launches > before["blocks"]
    assert crc32c_cuda.crc32c_chunks_device.launches > before["chunks"]
    assert rs_cuda.gf_matmul_words.launches - before["gf"] == \
        (nblocks if degraded else 0)
    for name, want in tree.items():
        assert on_card[name].device == cuda_device
        for got in (on_card[name].cpu(), on_cpu[name]):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got.reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8)), name


def test_rs_3_2_decode_at_block_width_matches_plain(cuda_device):
    """The cold copy's rebuild: RS(3,2) with shards 0 and 3 lost, a 3x3
    matrix at one 64 MiB block's padded shard width (5,592,416 words)."""
    present = (1, 2, 4)
    w = rs_cuda.pad_shard_len(-(-(64 << 20) // 3)) // 4
    assert w == 5_592_416
    dec = rs_cuda.matrix_bits_device(rs_cuda.decode_matrix(3, 2, present),
                                     cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    words = torch.randint(-(1 << 31), 1 << 31, (3, w), dtype=torch.int32,
                          device=cuda_device, generator=gen).view(torch.uint32)
    before = rs_cuda.gf_matmul_words.launches
    got = rs_cuda.gf_matmul_words(words, dec)
    assert rs_cuda.gf_matmul_words.launches == before + 1
    want = rs_cuda.gf_rows_plain(words, dec)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_restore_and_dataset_phases_on_card(cuda_device, tmp_path):
    import chip_smoke

    r = chip_smoke.restore_path(cuda_device, params=200_003,
                                block_size=1 << 20, workdir=tmp_path)
    assert r["exact"] and r["degraded_shard_reads"] == 0
    assert r["flipped"]["rereads"] == 1
    assert r["degraded"]["degraded_shard_reads"] == 1
    assert all(r["launches"][k] > 0 for k in chip_smoke.PATH_KERNELS["restore"])
    d = chip_smoke.dataset_path(cuda_device, file_bytes=8 << 20,
                                block_size=1 << 20, batches=30,
                                num_workers=0, workdir=tmp_path)
    assert d["exact"] and d["batches"] == 30
    assert list(tmp_path.iterdir()) == []
