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
