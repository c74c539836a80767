"""The port's hand-written CUDA kernels against their plain PyTorch twins,
on the card. Each test takes the ``cuda_device`` fixture and skips, with
its reason, on a host without a card: a CUDA kernel has no CPU or
interpret mode. This file imports no jax. The tests that need a cluster
start one with the port's launcher (``tpudfs_torch.cluster``: the
system's servers as processes) or import the reference's
``InprocCluster`` or client (none of which imports JAX) inside their
bodies. So the file also runs on a card host that has no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import asyncio

import numpy as np
import pytest
import torch

from tpudfs_torch.client.local import DfsError, LocalClient
from tpudfs_torch.cluster import ProcessCluster
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
    group's staging CRC) against the numpy twin ``crc32c_chunks_plain``,
    short last chunks included. Needs no card."""
    from tpudfs_torch.common import checksum, native

    rng = np.random.default_rng(12)
    for n in (0, 1, 511, 512, 513, 4096 * 3 + 17, 1 << 20):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        want = checksum.crc32c_chunks_plain(data)
        np.testing.assert_array_equal(native.crc32c_chunks(data), want)
        np.testing.assert_array_equal(native.crc32c_chunks(data.tobytes()), want)
    np.testing.assert_array_equal(
        native.crc32c_chunks(data, 4096),
        checksum.crc32c_chunks_plain(data, 4096))


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
    states, the bf16 model, an int64 step, an int8 tail; and a complex64
    tensor) laid out as the manager saves it (3x hot copy + RS(3,2) cold
    copy) in 64 KiB blocks; (client, spec, tree on the CPU, metas)."""
    import chip_smoke
    from tpudfs_torch.common.checksum import crc32c
    from tpudfs_torch.gpu.checkpoint import pack_shard

    tree = chip_smoke.ckpt_state(30_011, seed, CPU)
    gen = torch.Generator().manual_seed(seed)
    tree["z"] = torch.randn(1001, dtype=torch.complex64, generator=gen)
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
    # The bf16 weights and the complex64 tensor are 2- and 8-byte views of
    # the word stream in cuda:0, each checked by its own CRC there.
    assert (tree["model"].dtype, tree["z"].dtype) == (torch.bfloat16,
                                                      torch.complex64)
    for name, want in tree.items():
        assert on_card[name].device == cuda_device
        for got in (on_card[name].cpu(), on_cpu[name]):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got.reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8)), name


def test_restore_lands_blocks_through_pinned_slots_on_card(cuda_device,
                                                           tmp_path):
    """Two healthy restores into ``cuda:0`` in a row, the second landing in
    the slots the first gave back: each uploads every block from the
    reader's pinned slots (its padded bytes in ``h2d.pinned_bytes``) and
    nothing from pageable memory, bit-exact; the pool holds no slot taken
    afterwards."""
    from tpudfs_torch.common import trace
    from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE
    from tpudfs_torch.gpu.checkpoint import restore_shard_device

    client, spec, tree, metas = _shard_layout(tmp_path, seed=63)
    _restore(client, spec, cuda_device)  # the kernels' tables: uploaded once
    reader = HbmReader(client, [cuda_device])
    blocks = sum(-(-b["size"] // CHECKSUM_CHUNK_SIZE) * CHECKSUM_CHUNK_SIZE
                 for b in metas["/c/hot"]["blocks"])
    for _ in range(2):
        before = trace.counts()
        out = asyncio.run(restore_shard_device(
            reader, client, spec, cuda_device, {"degraded_shard_reads": 0}))
        torch.cuda.synchronize(cuda_device)
        after = trace.counts()
        moved = {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("h2d.pinned_bytes", "h2d.pageable_bytes")}
        assert moved == {"h2d.pinned_bytes": blocks,
                         "h2d.pageable_bytes": 0}
        for name, want in tree.items():
            got = out[name]
            assert got.device == cuda_device and got.dtype == want.dtype
            assert torch.equal(got.cpu().reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8)), name
    pool = reader._pools[cuda_device]
    assert pool.pinned and pool.held == sum(
        s.nbytes for free in pool._free.values() for s in free)


def test_cold_restore_lands_ec_blocks_through_pinned_slots_on_card(
        cuda_device, tmp_path):
    """Three cold restores into ``cuda:0`` in a row, the hot copy's
    replicas gone and shards 0 and 3 of every RS(3,2) block lost: every
    block is rebuilt from rows landed straight in the reader's pinned
    slots (three a block, none copied), nothing is uploaded from pageable
    memory, every tensor is bit-exact with the tree it was packed from,
    and the third restore allocates no slot. Each slot holds a power of
    two, and none stays taken."""
    import chip_smoke
    from tpudfs_torch.common import trace
    from tpudfs_torch.gpu.checkpoint import restore_shard_device

    client, spec, tree, metas = _shard_layout(tmp_path, seed=64)
    for block in metas["/c/hot"]["blocks"]:
        for addr in block["locations"]:
            client._local_stores[addr][0].block_path(
                block["block_id"]).unlink()
    chip_smoke._drop_shards(client, metas["/c/ec"], (0, 3))
    nblocks = len(metas["/c/ec"]["blocks"])
    _restore(client, spec, cuda_device)  # the kernels' tables: uploaded once
    reader = HbmReader(client, [cuda_device])
    names = ("h2d.pageable_bytes", "ec.rows_landed", "ec.rows_copied",
             "ec.blocks_rebuilt", "reader.slot_allocs")
    for i in range(3):
        stats = {"degraded_shard_reads": 0}
        before = trace.counts()
        out = asyncio.run(restore_shard_device(reader, client, spec,
                                               cuda_device, stats))
        torch.cuda.synchronize(cuda_device)
        after = trace.counts()
        moved = {k: after.get(k, 0) - before.get(k, 0) for k in names}
        assert stats["degraded_shard_reads"] == 1
        assert moved["h2d.pageable_bytes"] == 0, moved
        assert moved["ec.rows_landed"] == 3 * nblocks, moved
        assert moved["ec.rows_copied"] == 0, moved
        assert moved["ec.blocks_rebuilt"] == nblocks, moved
        if i == 2:
            assert moved["reader.slot_allocs"] == 0, moved
        for name, want in tree.items():
            got = out[name]
            assert got.device == cuda_device and got.dtype == want.dtype
            assert torch.equal(got.cpu().reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8)), name
        del out
    pool = reader._pools[cuda_device]
    slots = [s for free in pool._free.values() for s in free]
    assert pool.pinned and pool.held == sum(s.nbytes for s in slots)
    assert all(s.nbytes & (s.nbytes - 1) == 0 for s in slots)


def test_restore_checks_non_word_tensors_by_their_own_crc_on_card(
        cuda_device, tmp_path, monkeypatch):
    """The tensors that are not 4-byte words (bf16 weights, int64 step,
    int8 flags, complex64) come back in ``cuda:0`` as views of the word
    stream, bit-exact: each checked by one more launch of the fused CRC
    kernel, none by the host CRC over its bytes; ``stage_s`` splits
    ``bounce`` into ``bounce_copy`` and ``bounce_crc``; the counters give
    their bytes and no clone."""
    from tpudfs_torch.common import trace
    from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE
    from tpudfs_torch.gpu import checkpoint

    client, spec, tree, metas = _shard_layout(tmp_path, seed=62)
    non_word = [t for t in spec["tensors"]
                if checkpoint.torch_dtype(t["dtype"]).itemsize != 4]
    assert sorted(t["name"] for t in non_word) == ["flags", "model", "step",
                                                   "z"]
    full = sum(b["size"] % CHECKSUM_CHUNK_SIZE == 0
               for b in metas["/c/hot"]["blocks"])
    reader = HbmReader(client, [cuda_device])
    _restore(client, spec, cuda_device)  # the kernels' tables: uploaded once
    host_crcs, real = [], checkpoint.crc32c

    def host_crc(data, crc=0):
        host_crcs.append(data)
        return real(data, crc)

    monkeypatch.setattr(checkpoint, "crc32c", host_crc)
    launches = crc32c_cuda.crc32c_blocks_device.launches
    before = trace.counts()
    stage = {}
    out = asyncio.run(checkpoint.restore_shard_device(
        reader, client, spec, cuda_device, {"degraded_shard_reads": 0},
        stage_s=stage))
    torch.cuda.synchronize(cuda_device)
    after = trace.counts()
    assert crc32c_cuda.crc32c_blocks_device.launches - launches == \
        full + len(non_word)
    # The host engine CRCs the zeros that pad each tensor's chunk range
    # (its side of the compare), never a tensor's bytes.
    assert len(host_crcs) == len(non_word)
    assert all(isinstance(d, bytes) and len(d) < 512 and not any(d)
               for d in host_crcs)
    assert {k: after.get(k, 0) - before.get(k, 0)
            for k in ("restore.tensor_crc_bytes",
                      "restore.tensor_clones")} == {
        "restore.tensor_crc_bytes": sum(t["size"] for t in non_word),
        "restore.tensor_clones": 0}
    assert stage["bounce_crc"] > 0 and stage["bounce_copy"] > 0
    assert stage["bounce"] == pytest.approx(stage["bounce_copy"]
                                            + stage["bounce_crc"])
    stream = out["params"].untyped_storage().data_ptr()
    for name, want in tree.items():
        got = out[name]
        assert (got.device, got.dtype, got.shape) == \
            (cuda_device, want.dtype, want.shape), name
        assert got.untyped_storage().data_ptr() == stream, name
        assert torch.equal(got.cpu().reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8)), name


def test_restore_on_card_refuses_a_flipped_tensor_crc_and_clones_an_odd_offset(
        cuda_device, tmp_path):
    """On the card: a spec whose CRC of the bf16 weights is one bit off
    fails naming them; a hand-packed payload (uint8 flags at 0, an int64
    tensor right after them at offset 4, so the flags' chunk range holds
    bytes) restores bit-exact, the int64 tensor through one clone."""
    from tpudfs_torch.client.local import ChecksumMismatchError
    from tpudfs_torch.common import trace
    from tpudfs_torch.common.checksum import crc32c
    import chip_smoke

    client, spec, _, _ = _shard_layout(tmp_path, seed=64)
    flipped = {**spec, "tensors": [
        {**t, "crc32c": t["crc32c"] ^ 1} if t["name"] == "model" else t
        for t in spec["tensors"]]}
    with pytest.raises(ChecksumMismatchError, match="'model'"):
        _restore(client, flipped, cuda_device)
    rng = np.random.default_rng(65)
    tree = {"flags": rng.integers(0, 256, 4, dtype=np.uint8),
            "i8": rng.integers(-2**62, 2**62, 37, dtype=np.int64),
            "w": rng.standard_normal(100, dtype=np.float32)}
    payload, tensors = bytearray(), []
    for (name, arr), off in zip(tree.items(), (0, 4, 512)):
        payload.extend(b"\0" * (off - len(payload)))
        tensors.append({"name": name, "dtype": arr.dtype.str,
                        "shape": list(arr.shape), "offset": off,
                        "size": arr.nbytes, "crc32c": crc32c(arr.tobytes())})
        payload.extend(arr.tobytes())
    (tmp_path / "b").mkdir()
    stores, metas = chip_smoke.lay_out_shard(
        tmp_path / "b", np.frombuffer(bytes(payload), dtype=np.uint8),
        block_size=64 * 1024, hot="/c/hot", cold="/c/ec")
    client = LocalClient(stores, metas)
    spec = {"shard": 0, "path": "/c/hot", "ec_path": "/c/ec",
            "size": len(payload), "crc32c": crc32c(bytes(payload)),
            "tensors": tensors}
    before = trace.counts()
    out, _ = _restore(client, spec, cuda_device)
    assert trace.counts()["restore.tensor_clones"] - \
        before.get("restore.tensor_clones", 0) == 1
    for name, want in tree.items():
        assert out[name].device == cuda_device
        assert out[name].cpu().numpy().tobytes() == want.tobytes(), name


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
    assert r["tensors"]["model"] == ["<V2", [200_003]]
    assert r["flipped"]["rereads"] == 1
    assert r["degraded"]["degraded_shard_reads"] == 1
    assert all(r["launches"][k] > 0 for k in chip_smoke.PATH_KERNELS["restore"])
    d = chip_smoke.dataset_path(cuda_device, file_bytes=8 << 20,
                                block_size=1 << 20, batches=30,
                                num_workers=0, workdir=tmp_path)
    assert d["exact"] and d["batches"] == 30
    assert list(tmp_path.iterdir()) == []


# ------------------------------------------ entry step and dryrun


@pytest.mark.parametrize("chunks", [96, 3 * 2048])
def test_entry_step_on_card_matches_cpu(cuda_device, chunks):
    """``graft_entry.entry``'s step on the card equals its CPU result, with
    the expected CRCs as made and with one poisoned; each call launches the
    chunk CRC twice (the batch, then the write step's 3-group verify) and
    the GF(2^8) kernel once (the parity)."""
    from tpudfs_torch import graft_entry

    out = {}
    for dev in (cuda_device, CPU):
        step, (words, crcs) = graft_entry.entry(dev, chunks=chunks)
        poisoned = crcs.clone()
        poisoned.view(torch.int32)[1] ^= 0x5A5A5A5A
        crc0 = crc32c_cuda.crc32c_chunks_device.launches
        gf0 = rs_cuda.gf_matmul_words.launches
        runs = [step(words, c) for c in (crcs, poisoned)]
        if dev.type == "cuda":
            assert crc32c_cuda.crc32c_chunks_device.launches == crc0 + 4
            assert rs_cuda.gf_matmul_words.launches == gf0 + 2
            assert all(t.device == cuda_device for r in runs
                       for t in r.values())
        out[dev.type] = [{k: v.cpu() for k, v in r.items()} for r in runs]
    for got, want in zip(out["cuda"], out["cpu"]):
        for key in want:
            assert torch.equal(got[key].reshape(-1).view(torch.uint8),
                               want[key].reshape(-1).view(torch.uint8)), key
    assert [bool(r["write_ok"]) for r in out["cuda"]] == [True, False]
    assert [int(r["write_acks"]) for r in out["cuda"]] == [1, 0]


def test_dryrun_nine_positions_on_one_card(cuda_device):
    """``dryrun_body`` with 9 positions sharing the card: every leg checks
    itself on the card, and each leg launches the kernels the ring needs
    (n positions: the write step n verifies + n parities; the scatter 2n
    CRCs + n encodes, the gather n decodes; the 3x3 pod's chain n verifies
    and its RS(1,2) scatter 2n CRCs + n encodes)."""
    from tpudfs_torch import graft_entry

    n = 9
    r = graft_entry.dryrun_body([cuda_device] * n, chunks_per_position=64)
    assert r["devices"] == [str(cuda_device)] * n
    assert (r["ec"], r["exact"], r["write_acks"]) == ([6, 3], True, n)
    assert r["pod"]["shape"] == [3, 3] and r["pod"]["acks"] == n
    legs = r["leg_launches"]
    assert legs["write"] == {"crc32c_chunks": n, "crc32c_blocks": 0,
                             "gf256_matmul": n}
    assert legs["scatter_gather"] == {"crc32c_chunks": 2 * n,
                                      "crc32c_blocks": 0,
                                      "gf256_matmul": 2 * n}
    assert legs["pod"] == {"crc32c_chunks": 3 * n, "crc32c_blocks": 0,
                           "gf256_matmul": n}
    assert r["launches"] == {"crc32c_chunks": 6 * n, "crc32c_blocks": 0,
                             "gf256_matmul": 4 * n}


def test_entry_and_dryrun_phases_on_card(cuda_device):
    import chip_smoke

    e = chip_smoke.entry_phase(cuda_device, chunks=3 * 1024)
    assert e["parity_exact"] and e["tamper"]["write_ok"] is False
    assert e["launches"]["crc32c_chunks"] == 4
    assert e["launches"]["gf256_matmul"] == 2
    d = chip_smoke.dryrun_phase(cuda_device, chunks_per_position=256)
    assert all(r["exact"] for r in d["runs"].values())
    for r in d["runs"].values():
        assert set(r["busy"]) == set(r["seconds"])
        assert all(0 < b["busy_share"] <= 1 for b in r["busy"].values())
    assert all(d["launches"][k] > 0 for k in chip_smoke.PATH_KERNELS["dryrun"])


def test_live_write_and_soak_on_card(cuda_device):
    """The live collective-write leg on 4 positions of the card and one
    soak round per fault kind on 3, each on the reference's InprocCluster
    with the port's group (its hook bound on every chunkserver). Prints one
    ``LIVE_ON_CARD`` JSON line: each run's seconds and kernel launches."""
    import json
    import random
    import time

    from tpudfs.common import native as ref_native
    from tpudfs.testing.inproc import InprocCluster
    from tpudfs_torch.graft_entry import launch_counts, live_collective_write
    from tpudfs_torch.ici_roulette import KINDS, run_round

    # The reference's chunkservers build its native library at first use;
    # build it here, outside the timed runs, as tests/conftest.py does.
    t0 = time.perf_counter()
    ref_native.build_and_load()
    native_build_s = time.perf_counter() - t0

    def timed(fn) -> tuple:
        before, t0 = launch_counts(), time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        after = launch_counts()
        return out, {"seconds": seconds,
                     "launches": {k: after[k] - before[k] for k in after}}

    msg, live = timed(lambda: live_collective_write(
        [cuda_device] * 4, cluster_factory=InprocCluster))
    assert "garbage member EC(2,2) gather reconstructed" in msg
    assert "3 puts during failover" in msg and "fallback(s))" in msg
    assert live["launches"]["crc32c_chunks"] > 0
    assert live["launches"]["gf256_matmul"] > 0
    report = {"device": torch.cuda.get_device_name(0),
              "native_build_s": native_build_s, "live": live,
              "live_message": msg}
    for i, kind in enumerate(KINDS, 1):
        r, cost = timed(lambda: run_round(
            [cuda_device] * 3, InprocCluster, i,
            random.Random((42 << 16) ^ i), 42, plan=[kind]))
        assert r["bit"] == [kind] and r["puts_checked"] >= 24, r
        assert cost["launches"]["crc32c_chunks"] >= r["rounds"]
        report[kind] = {**cost, **r}
    print("LIVE_ON_CARD " + json.dumps(report), flush=True)


def test_bench_against_process_cluster_on_card(cuda_device, tmp_path):
    """``python3 -m tpudfs_torch.bench``'s default run: the port's bench,
    remote windows and all, against 1 master and 3 chunkserver processes
    spawned by the port's launcher, through the port's own ``Client`` (1
    MiB blocks, CRC-64 ETags), full constants, on ``cuda:0``. Prints one
    ``BENCH_ON_CARD`` JSON line: the result, the run's seconds and its
    kernel launches; no module of the JAX package is loaded by the run."""
    import json
    import sys
    import time

    from tpudfs_torch import bench
    from tpudfs_torch.graft_entry import launch_counts

    loaded = {m for m in sys.modules if m.split(".")[0] == "tpudfs"}
    before, t0 = launch_counts(), time.perf_counter()
    result = bench.run_remote(cuda_device, tmp_path)
    seconds = time.perf_counter() - t0
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    assert {m for m in sys.modules if m.split(".")[0] == "tpudfs"} == loaded
    assert result["remote"] is True and result["files"] == bench.FILES
    assert result["value"] > 0 and result["grpc_read_GBps"] > 0
    assert result["write_pipeline_GBps"] > 0 and result["cache_read_ops"] > 0
    assert result["platform"] == "gpu"
    # The gRPC sweeps' fused rounds verify on the card, the write step
    # with the chunk CRCs, the scatter's encode with GF(2^8).
    assert all(n > 0 for n in launches.values()), launches
    report = {"device": result["device"],
              "setup_s": result["cluster_start_s"], "seconds": seconds,
              "launches": launches, "result": result}
    print("BENCH_ON_CARD " + json.dumps(report), flush=True)


def test_bench_remote_windows_reference_and_port_clients_on_card(
        cuda_device, tmp_path):
    """The bench's remote windows on one cluster of 1 master and 3
    chunkserver processes, through the reference's ``Client`` (P) and the
    port's (C) in turns P, C, C, P, full constants, the file sets deleted
    between runs. Prints one ``CLIENTS_ON_CARD`` JSON line with each run's
    headline numbers."""
    import json

    from tpudfs.client.client import Client as RefClient
    from tpudfs.common.rpc import RpcClient as RefRpcClient
    from tpudfs_torch import bench
    from tpudfs_torch.client.client import Client

    keys = ("value", "warm_infeed_read_GBps", "grpc_read_GBps",
            "write_pipeline_GBps", "meta_creates_per_s",
            "meta_fused_creates_per_s", "cache_read_GBps", "confirm_s")
    runs = []
    with ProcessCluster(tmp_path, n_cs=3,
                        cache_blocks=bench.CS_CACHE_BLOCKS) as cluster:
        maddr = cluster.master_addr

        async def run(which: str) -> dict:
            if which == "reference":
                rpc = RefRpcClient()
                client = RefClient([maddr], rpc_client=rpc,
                                   block_size=bench.BLOCK_BYTES,
                                   etag_mode="crc64")
            else:
                client = Client([maddr], block_size=bench.BLOCK_BYTES,
                                etag_mode="crc64")
                rpc = client.rpc
            try:
                result = await bench.run_against(client, cuda_device,
                                                 rpc_call=rpc.call)
                for path in await client.list_files("/bench/"):
                    await client.delete_file(path)
                return result
            finally:
                await client.close()
                await rpc.close()

        for which in ("reference", "port", "port", "reference"):
            result = asyncio.run(run(which))
            assert result["remote"] is True and result["platform"] == "gpu"
            runs.append({"client": which,
                         **{k: result[k] for k in keys},
                         "samples": result["debug_samples"]})
    print("CLIENTS_ON_CARD " + json.dumps(runs), flush=True)


def test_ckpt_bench_against_process_cluster_on_card(cuda_device, tmp_path):
    """``python3 -m tpudfs_torch.bench --ckpt``: the port's checkpoint
    bench on 1 master and 5 chunkserver processes spawned by the port's
    launcher, through the port's ``Client``, restores into device memory
    on ``cuda:0``, the two chunkservers holding the most data shards of
    its EC-only checkpoint SIGKILLed before the degraded restores, which
    read with the local short circuit off: every block that lost a data
    shard is rebuilt on the card. Prints one ``CKPT_ON_CARD`` JSON line:
    the result, its seconds and its kernel launches."""
    import json
    import time

    from tpudfs_torch import bench
    from tpudfs_torch.graft_entry import launch_counts

    before, t0 = launch_counts(), time.perf_counter()
    result = bench.run_remote_ckpt(cuda_device, tmp_path)
    seconds = time.perf_counter() - t0
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    assert result["platform"] == "gpu" and result["restored_to"] == "cuda:0"
    for key in ("ckpt_save_GBps", "ckpt_restore_GBps",
                "ckpt_restore_degraded_GBps", "plain_write_GBps"):
        assert result[key] > 0, key
    # Every restored block is verified on the card; the degraded restores
    # rebuild through the GF(2^8) decode.
    assert launches["crc32c_blocks"] + launches["crc32c_chunks"] > 0, launches
    lost = result["ckpt_degraded_blocks_lost_data"]
    assert result["ckpt_degraded_rebuilds"] == lost > 0, result
    assert result["ckpt_degraded_gf256_launches"] >= lost, result
    assert launches["gf256_matmul"] >= (bench.REPS + 1) * lost, launches
    report = {"seconds": seconds, "launches": launches, "result": result,
              "rebuild_decode": _rebuild_decode_row(cuda_device),
              "device": torch.cuda.get_device_name(0)}
    print("CKPT_ON_CARD " + json.dumps(report), flush=True)


def test_ckpt_bench_reference_and_port_clients_on_card(cuda_device,
                                                       tmp_path):
    """``run_ckpt`` through the reference's ``Client`` (P) and the port's
    (C) in turns P, C, C, P, each on a fresh cluster of 1 master and 5
    chunkserver processes (the two it names SIGKILLed), restores into
    ``cuda:0``. Prints one ``CKPT_CLIENTS_ON_CARD`` JSON line with each
    run's numbers."""
    import json

    from tpudfs.client.client import Client as RefClient
    from tpudfs_torch import bench
    from tpudfs_torch.client.client import Client

    runs = []
    for i, which in enumerate(("reference", "port", "port", "reference")):
        with ProcessCluster(tmp_path / f"run{i}", n_cs=5,
                            cache_blocks=bench.CS_CACHE_BLOCKS) as cluster:
            maddr = cluster.master_addr

            def kill_two(victims, cluster=cluster) -> None:
                for cs in cluster.chunkservers:
                    if cs.addr in victims:
                        cs.kill()

            async def run() -> dict:
                cls = RefClient if which == "reference" else Client
                client = cls([maddr], block_size=bench.BLOCK_BYTES,
                             etag_mode="crc64")
                try:
                    return await bench.run_ckpt(client, kill_two,
                                                cuda_device)
                finally:
                    await client.close()

            result = asyncio.run(run())
        runs.append({"client": which, **{
            k: result[k] for k in (
                "ckpt_save_GBps", "ckpt_save_win", "ckpt_restore_GBps",
                "ckpt_restore_win", "ckpt_restore_degraded_GBps",
                "ckpt_degraded_rebuilds", "ckpt_degraded_gf256_launches",
                "plain_write_GBps")}})
    print("CKPT_CLIENTS_ON_CARD " + json.dumps(runs), flush=True)


#: Seconds until the process master drops a dead chunkserver: its 15 s
#: liveness cutoff, its 5 s check interval and a heartbeat of slack.
MASTER_DROPS_DEAD_S = 21.0


def _ckpt_chaos_parts(device, root, kib: int) -> dict:
    """The three checkpoint chaos stages of ``tpudfs_torch.ckpt_chaos``,
    each on a fresh cluster of 1 master and 5 chunkserver processes (the
    reference ``Client`` at 1 MiB blocks, its local short circuit off so
    that a killed chunkserver's disk is out of reach, restores through an
    ``HbmReader`` on ``device``), kills by SIGKILL: the RS(3,2) rebuild
    after the data-shard holders die, saves through a seeded kill plan
    with their settle-and-verify, and kill-mid-checkpoint (last: it leaves
    2 of 5 chunkservers alive). Returns each part's seconds, its kernel
    launches and its result."""
    import random
    import time

    from tpudfs.client.client import Client
    from tpudfs.common.rpc import RpcClient
    from tpudfs_torch import bench
    from tpudfs_torch import ckpt_chaos as cc
    from tpudfs_torch.graft_entry import launch_counts

    async def rebuild(client, servers, reader):
        by_addr = {p.addr: p for p in servers}

        def kill(victims):
            for addr in victims:
                by_addr[addr].kill()

        return await cc.rebuild_after_kills(
            client, kill, base="/chaos/ec", kib=kib, reader=reader,
            device=device)

    async def faults(client, servers, reader):
        by_addr = {p.addr: p for p in servers}
        rng = random.Random(10)
        plan = cc.kill_plan(rng, by_addr)
        mgr = cc.roulette_manager(client, reader=reader)
        attempted, published = await cc.save_through_faults(
            mgr, steps=4, rng=rng, kib=kib,
            faults=lambda: cc.run_kill_plan(
                plan, lambda a: by_addr[a].kill()))
        out = await cc.settle_and_verify(mgr, attempted, published,
                                         kib=kib, device=device)
        return {"plan": plan, "attempted": attempted, **out}

    async def t10(client, servers, reader):
        async def kill_first():
            servers[0].kill()
            await asyncio.sleep(MASTER_DROPS_DEAD_S)

        def kill_mid():
            for p in servers[1:3]:
                p.kill()

        return await cc.kill_mid_checkpoint(
            client, kill_first, kill_mid, base="/chaos/t10", kib=kib,
            reader=reader, device=device)

    report = {}
    if device.type == "cuda":
        # The kernels' builds and the card's context, outside the parts'
        # timed restores.
        from tpudfs_torch.gpu import kernels

        t0 = time.perf_counter()
        for name in kernels.build():
            kernels.lib(name)
        torch.zeros(1, device=device).sum().item()
        report["warm_s"] = time.perf_counter() - t0
    for name, stage in (("rebuild", rebuild), ("faults", faults),
                        ("kill_mid", t10)):
        part_root = root / name
        part_root.mkdir()
        with ProcessCluster(part_root, n_cs=5,
                            cache_blocks=bench.CS_CACHE_BLOCKS) as cluster:
            maddr, servers = cluster.master_addr, cluster.chunkservers

            async def run() -> dict:
                rpc = RpcClient()
                try:
                    client = Client([maddr], rpc_client=rpc,
                                    block_size=1 << 20, etag_mode="crc64",
                                    rpc_timeout=3.0, max_retries=8,
                                    local_reads=False)
                    # The launcher returns once every chunkserver is
                    # registered: RS(3,2) places on 5.
                    return await stage(client, servers,
                                       HbmReader(client, [device]))
                finally:
                    await rpc.close()

            before, t0 = launch_counts(), time.perf_counter()
            result = asyncio.run(run())
            seconds = time.perf_counter() - t0
            after = launch_counts()
        report[name] = {"seconds": seconds,
                        "launches": {k: after[k] - before[k] for k in after},
                        "result": result}
    return report


def _rebuild_decode_row(device) -> dict:
    """The rebuild's GF(2^8) decode at the chaos checkpoint's block width
    (one 1 MiB block, RS(3,2), data shards 0 and 1 lost): device time
    against the plain twin's result and time and the byte bound (each
    survivor read once, each data shard written once, at 3.35 TB/s), and
    one call's time on an idle stream."""
    import time

    from tpudfs_torch.gpu.kernels import time_ms
    from tpudfs_torch.gpu.rs_cuda import pad_shard_len, rs_decode_device

    slen = -(-(1 << 20) // 3)
    rng = np.random.default_rng(11)
    host = torch.from_numpy(rng.integers(
        0, 256, (3, pad_shard_len(slen)), dtype=np.uint8))
    avail = host.to(device)
    present = (2, 3, 4)
    got = rs_decode_device(avail, 3, 2, present).cpu()
    t0 = time.perf_counter()
    want = rs_decode_device(host, 3, 2, present)
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert torch.equal(got, want)
    def decode():
        return rs_decode_device(avail, 3, 2, present)

    return {"shape": list(avail.shape), "ms": time_ms(decode),
            "call_ms": time_ms(decode, held=False), "plain_ms": plain_ms,
            "bound_ms": 2 * avail.numel() / 3.35e12 * 1e3}


def test_ckpt_chaos_on_card(cuda_device, tmp_path):
    """The checkpoint stages of the fault tiers against chunkserver
    processes, every restore into ``cuda:0`` bit-exact (each stage checks
    it), at 16 MiB trees (about 13 MiB a shard, 1 MiB blocks). Prints one
    ``CHAOS_ON_CARD`` JSON line: each part's seconds, result and kernel
    launches."""
    import json

    report = _ckpt_chaos_parts(cuda_device, tmp_path, 16384)
    for name in ("rebuild", "faults", "kill_mid"):
        launches = report[name]["launches"]
        assert launches["crc32c_blocks"] + launches["crc32c_chunks"] > 0, \
            (name, launches)
    rebuilt = report["rebuild"]
    assert rebuilt["result"]["blocks_lost_data"] > 0, rebuilt
    assert rebuilt["launches"]["gf256_matmul"] > 0, rebuilt
    assert rebuilt["result"]["gf256_launches"] \
        >= rebuilt["result"]["blocks_lost_data"], rebuilt
    # The kill plan starts once step 1 is acked: the settle's check that
    # every acked step is listed has something to hold.
    assert report["faults"]["result"]["acked"], report["faults"]
    kill_mid = report["kill_mid"]["result"]
    assert kill_mid["mid_save"] and kill_mid["interrupted"], kill_mid
    puts = kill_mid["resume_puts"]
    assert puts[0] == 0 and puts[1] >= 1, kill_mid
    report["rebuild_decode"] = _rebuild_decode_row(cuda_device)
    report["device"] = torch.cuda.get_device_name(0)
    print("CHAOS_ON_CARD " + json.dumps(report), flush=True)


#: The roulette axis's seed on the sharded deployment: its plan SIGKILLs
#: one chunkserver, partitions shard-z's leader (shard-z owns the
#: checkpoint) from the saving client for 3.5 s, SIGKILLs a follower of
#: shard-0 and then shard-z's leader: every kind of fault the roulette
#: draws.
SHARDED_PLAN_SEED = 21


def _sharded_chaos_parts(device, root, kib: int,
                         seed: int = SHARDED_PLAN_SEED) -> dict:
    """The fault tier's checkpoint stages on the system's own deployment:
    ``TopologyCluster`` on ``deploy/topologies/two-shard-ha.json`` with TLS
    (a fresh one a stage), the port's client built as the reference's
    tiers build theirs (every master, the config server, ``ClientTls``,
    256 KiB blocks, ``rpc_timeout=3.0``, ``max_retries=8``, no local
    short circuit), restores through an ``HbmReader`` on ``device``:
    kill-mid-checkpoint at ``/a/chaos-ckpt`` (t10, hot-only), then the
    roulette's checkpoint axis at ``/a/roulette-ckpt`` (RS(2,1)) through
    ``kill_plan(..., shards=)``'s seeded chunkserver and master kills and
    shard-leader partitions (``tpudfs_torch.netem.FaultProxy`` between
    the saving client and the leader), with its settle-and-verify. Returns each stage's seconds, kernel
    launches and result."""
    import random
    import time
    from pathlib import Path

    from tpudfs_torch import ckpt_chaos as cc
    from tpudfs_torch.client.client import Client
    from tpudfs_torch.cluster import TopologyCluster, find_leader_async
    from tpudfs_torch.graft_entry import launch_counts
    from tpudfs_torch.netem import FaultProxy

    topology = Path(__file__).resolve().parents[1] / "deploy" \
        / "topologies" / "two-shard-ha.json"

    async def t10(cluster, client, reader):
        servers = cluster.chunkservers

        async def kill_first():
            servers[0].kill()
            await asyncio.sleep(MASTER_DROPS_DEAD_S)

        def kill_mid():
            for p in servers[1:3]:
                p.kill()

        return await cc.kill_mid_checkpoint(
            client, kill_first, kill_mid, base="/a/chaos-ckpt", kib=kib,
            reader=reader, device=device)

    async def roulette(cluster, client, reader):
        by_name = {cs.name: cs for cs in cluster.chunkservers}
        rng = random.Random(seed)
        plan = cc.kill_plan(rng, by_name, shards=cluster.shards)
        # As the roulette does: a proxy in front of each partitioned
        # shard's leader as it stands at the start, which the saving
        # client reaches through a host alias (the reference aliases its
        # workload client; here it is the client that saves and
        # restores).
        proxies, aliases = {}, {}
        for sid in sorted({v.shard for _, v in plan
                           if isinstance(v, cc.Partition)}):
            leader = await find_leader_async(cluster.shards[sid],
                                             client=client)
            host, port = leader.rsplit(":", 1)
            proxies[sid] = FaultProxy(host, int(port))
            aliases[leader] = await proxies[sid].start()
        saver = Client(cluster.all_masters,
                       config_addrs=[cluster.config_addr],
                       tls=cluster.client_tls, block_size=256 * 1024,
                       rpc_timeout=3.0, max_retries=8, local_reads=False,
                       host_aliases=aliases)
        mgr = cc.roulette_manager(saver,
                                  reader=HbmReader(saver, [device]))
        kills = []

        async def partition(shard, duration):
            proxy = proxies[shard]
            proxy.partition()
            await asyncio.sleep(duration)
            proxy.heal()
            return {"via": proxy.address,
                    "upstream": f"{proxy.upstream_host}:"
                                f"{proxy.upstream_port}"}

        async def faults():
            kills.extend(await cc.run_kill_plan(
                plan, lambda name: by_name[name].kill(),
                lambda shard, leader: cluster.kill_master(
                    shard, leader, client=client), partition))

        try:
            attempted, published = await cc.save_through_faults(
                mgr, steps=4, rng=rng, kib=kib, faults=faults)
            out = await cc.settle_and_verify(mgr, attempted, published,
                                             kib=kib, device=device)
            ckpt_shard = saver.shard_map.get_shard(mgr.base + "/")
        finally:
            await saver.close()
            for proxy in proxies.values():
                await proxy.stop()
        return {"plan": [[t, v if isinstance(v, str) else v._asdict()]
                         for t, v in plan],
                "kills": kills, "attempted": attempted,
                "ckpt_shard": ckpt_shard, **out}

    report = {}
    for name, stage in (("t10", t10), ("roulette", roulette)):
        part_root = root / name
        part_root.mkdir()
        with TopologyCluster(part_root, topology, tls=True) as cluster:
            async def run() -> dict:
                client = Client(cluster.all_masters,
                                config_addrs=[cluster.config_addr],
                                tls=cluster.client_tls,
                                block_size=256 * 1024, rpc_timeout=3.0,
                                max_retries=8, local_reads=False)
                try:
                    return await stage(cluster, client,
                                       HbmReader(client, [device]))
                finally:
                    await client.close()

            before, t0 = launch_counts(), time.perf_counter()
            result = asyncio.run(run())
            seconds = time.perf_counter() - t0
            after = launch_counts()
            start_s = cluster.start_s
        report[name] = {"seconds": seconds, "start_s": start_s,
                        "launches": {k: after[k] - before[k] for k in after},
                        "result": result}
    return report


#: The Helm chart's events on the card: 80 MiB trees (one full 64 MiB
#: block and a tail a shard), the sharded phase's 150 calls a second on
#: the hot prefix, the masters' own 30 s split cooldown.
HELM_EVENT_KIB = 81920
HELM_BLOCK = 64 << 20
HELM_TRAFFIC_OPS = 150.0
MASTERS_COOLDOWN_S = 30.0


def _helm_fault_parts(device, root) -> dict:
    """Three fault events on one ``HelmCluster`` with the chart's values
    (TLS, 100 rps, the masters' 30 s cooldown, 5 chunkservers, its block
    cache) and two spare groups, through the port's client on the config
    servers alone (``block_size`` blocks, ``max_retries=8``, no short
    circuit), every restore through an ``HbmReader`` on ``device``:
    ``helm_chaos.config_failover_mid_split`` on ``/a/``,
    ``helm_chaos.split_in_cooldown`` on ``/b/``, then
    ``ckpt_chaos.kills_tear_checkpoint`` at ``/a/torn-ckpt`` (the shard
    ``/a/`` split to, which cannot split again). Returns each stage's
    seconds, kernel launches and result, the cluster's start and its
    departures from the chart. (Its CPU counterpart, at a small size, is
    ``tests/test_torch_helm_faults.py``.)"""
    import functools
    import time

    from tpudfs_torch import ckpt_chaos as cc
    from tpudfs_torch import helm_chaos as hc
    from tpudfs_torch.cluster import HelmCluster
    from tpudfs_torch.graft_entry import launch_counts

    kib, block_size = HELM_EVENT_KIB, HELM_BLOCK
    report = {}
    with HelmCluster(root, tls=True, spares=2) as cluster:
        factory = functools.partial(cluster.client, block_size=block_size,
                                    max_retries=8, local_reads=False)
        by_addr = {cs.addr: cs for cs in cluster.chunkservers}

        def split_event(fn, prefix):
            return lambda: fn(cluster, factory, prefix=prefix, kib=kib,
                              device=device, rate=HELM_TRAFFIC_OPS,
                              cooldown_s=MASTERS_COOLDOWN_S,
                              block_size=block_size)

        async def torn():
            client = factory()
            try:
                return await cc.kills_tear_checkpoint(
                    client, lambda v: [by_addr[a].kill() for a in v],
                    list(by_addr), base="/a/torn-ckpt", kib=kib,
                    reader=HbmReader(client, [device]), device=device,
                    ec=(2, 1))
            finally:
                await client.close()

        for name, stage in (
                ("config_failover_mid_split",
                 split_event(hc.config_failover_mid_split, "/a/")),
                ("split_in_cooldown",
                 split_event(hc.split_in_cooldown, "/b/")),
                ("kills_tear_checkpoint", torn)):
            before, t0 = launch_counts(), time.perf_counter()
            result = asyncio.run(stage())
            seconds = time.perf_counter() - t0
            after = launch_counts()
            report[name] = {"seconds": seconds,
                            "launches": {k: after[k] - before[k]
                                         for k in after},
                            "result": result}
        report["start_s"] = cluster.start_s
        report["departures"] = cluster.departures
    return report


def test_sharded_ckpt_chaos_on_card(cuda_device, tmp_path):
    """The fault tier's checkpoint stages on the two-shard-ha TLS
    deployment, every restore into ``cuda:0`` bit-exact (each stage checks
    it), at 4 MiB trees (about 3.4 MB a shard, 256 KiB blocks): t10 tears
    and resumes a save; the roulette axis's plan SIGKILLs at least one
    master (and the checkpoint shard's leader) and partitions at least
    one shard leader from the saving client, no torn step is listed,
    every acked step is listed. Then the Helm chart's three events
    (:func:`_helm_fault_parts`): a config failover mid-split, a split
    held by a new leader's 30 s cooldown, a save the kills alone tear.
    Prints one ``SHARDED_CHAOS_ON_CARD`` JSON line, before its checks."""
    import json

    report = _sharded_chaos_parts(cuda_device, tmp_path, 4096)
    helm = report["helm"] = _helm_fault_parts(cuda_device, tmp_path / "helm")
    report["device"] = torch.cuda.get_device_name(0)
    print("SHARDED_CHAOS_ON_CARD " + json.dumps(report), flush=True)
    for name in ("t10", "roulette"):
        launches = report[name]["launches"]
        assert launches["crc32c_blocks"] + launches["crc32c_chunks"] > 0, \
            (name, launches)
    t10 = report["t10"]["result"]
    assert t10["mid_save"] and t10["interrupted"], t10
    assert t10["resume_puts"][0] == 0 and t10["resume_puts"][1] >= 1, t10
    roulette = report["roulette"]["result"]
    masters = [k for k in roulette["kills"] if "leader" in k]
    assert masters and all(k["killed"] for k in masters), roulette
    partitions = [k for k in roulette["kills"] if "partitioned" in k]
    assert partitions and all(k["partitioned"] for k in partitions), \
        roulette
    assert any(k["shard"] == roulette["ckpt_shard"] and k["leader"]
               for k in masters), roulette
    assert roulette["acked"], roulette
    assert set(roulette["acked"]) <= set(roulette["listed"]), roulette
    assert set(roulette["restore_s"]) == set(roulette["listed"]), roulette
    mid = helm["config_failover_mid_split"]["result"]
    assert mid["save"]["shard0_puts"] == 0, mid
    assert mid["stale_map_redirects"] >= 1 and len(mid["voters"]) == 3, mid
    assert sum(map(len, mid["split_lines"].values())) == 1, mid
    cool = helm["split_in_cooldown"]["result"]
    assert cool["leader_to_split_s"] >= MASTERS_COOLDOWN_S, cool
    assert cool["restore_launches"]["crc32c_blocks"] >= \
        cool["full_blocks"] > 0, cool
    torn = helm["kills_tear_checkpoint"]
    assert torn["result"]["interrupted"] and torn["result"]["error"], torn
    assert torn["result"]["resume_puts"][0] == 0, torn
    assert torn["result"]["listed_torn"] == [1], torn
    # Two steps of two shards restored, one full block and a whole-chunk
    # tail each: each block's CRC folds on the card.
    assert torn["launches"]["crc32c_blocks"] >= 8, torn
