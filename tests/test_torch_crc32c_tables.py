"""The CRC32C kernel's arithmetic, emulated on the CPU and held bit-exact
against the JAX package.

``csrc/crc32c.cu`` builds its shared-memory tables in its prologue from the
arrays its wrapper passes (WCONTRIB, and the operator columns: the compact
``fold_ops()`` array or rows of a ``combine_fold_table``). This file builds
the same tables on the host and runs the kernel's steps in numpy: the
positional nibble lookups of each lane at the kernel's byte addresses,
the warp's XOR butterfly, the pick of chunk k by lane k in a tile counted
from the block's end, the per-lane
M^k, and the advance by M^(32t) composed from M^(32*2^q) with the 8-lane
lookup and its three shuffles. The results are compared with the reference's
``crc32c_chunks_device`` (jnp and Pallas interpret mode) and
``batch_block_crc_device``, and with the port's plain twins. Exact integer
functions: no tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudfs.common import checksum as ref_checksum
from tpudfs.tpu import crc32c_pallas as ref
from tpudfs_torch.common.checksum import combine_fold_table
from tpudfs_torch.gpu import host_to_device, u32_to_numpy
from tpudfs_torch.gpu import crc32c_cuda as port

CPU = torch.device("cpu")
LANES = np.arange(32)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, shape, dtype=np.uint32)


def _nib(x, j):
    return (x >> np.uint32(4 * j)) & np.uint32(15)


def _nibble_entries(cols):
    """cols (..., 4) -> (..., 16): entry v = XOR of cols[b] over set bits b."""
    out = np.zeros(cols.shape[:-1] + (16,), dtype=np.uint32)
    for v in range(16):
        for b in range(4):
            if v >> b & 1:
                out[..., v] ^= cols[..., b]
    return out


def chunk_tables(wcontrib):
    """(4, 8, 16, 32): tab[i][j][v][l] = XOR_{bit b of v} WCONTRIB[4j+b][4l+i]."""
    wc = np.asarray(wcontrib, dtype=np.uint32)
    tab = np.zeros((4, 8, 16, 32), dtype=np.uint32)
    for i in range(4):
        for j in range(8):
            cols = wc[4 * j : 4 * j + 4][:, 4 * LANES + i].T  # (32 lanes, 4)
            tab[i, j] = _nibble_entries(cols).T
    return tab


def chunk_smem(wcontrib):
    """The 64 KiB the kernel's prologue fills, as 16,384 words: even nibbles
    j = 2p of word i at (i*4 + p)*512 + v*32 + l, odd ones j = 2p+1 at
    8192 + v*512 + (i*4 + p)*32 + l."""
    tab = chunk_tables(wcontrib)
    flat = np.zeros(16384, dtype=np.uint32)
    v, lane = np.meshgrid(np.arange(16), LANES, indexing="ij")
    for i in range(4):
        for j in range(8):
            k = i * 4 + j // 2
            idx = (8192 + v * 512 + k * 32 + lane) if j % 2 \
                else (k * 512 + v * 32 + lane)
            flat[idx] = tab[i, j]
    return flat


def op_columns(ops, from_fold, cpb, dist, row):
    """The kernel's op_columns: fold row cpb-1-dist, or compact row ``row``."""
    return ops[cpb - 1 - dist] if from_fold else ops[row]


def lane_tables(ops, from_fold, cpb):
    """(8, 16, 32): lane l's nibble tables of M^l (zero where l >= cpb)."""
    tab = np.zeros((8, 16, 32), dtype=np.uint32)
    for lane in range(min(32, cpb)):
        cols = op_columns(ops, from_fold, cpb, lane, lane).reshape(8, 4)
        tab[:, :, lane] = _nibble_entries(cols)
    return tab


def advance_tables(ops, from_fold, cpb, nadv):
    """(nadv, 8, 16): nibble tables of M^(32 * 2^q)."""
    tab = np.zeros((nadv, 8, 16), dtype=np.uint32)
    for q in range(nadv):
        tab[q] = _nibble_entries(
            op_columns(ops, from_fold, cpb, 32 << q, 32 + q).reshape(8, 4))
    return tab


def butterfly(v):
    """__shfl_xor_sync over offsets 16..1 on the last (lane) axis."""
    for off in (16, 8, 4, 2, 1):
        v = v ^ v[..., LANES ^ off]
    return v


def emulate_chunks(words, wcontrib, inv):
    """The kernel's per-chunk CRCs: (C, 128) -> (C,), with its byte
    addresses into its shared-memory tables (word_xor)."""
    smem = chunk_smem(wcontrib)
    lane4 = (LANES * 4).astype(np.uint32)
    c = words.shape[0]
    padded = np.zeros((-(-c // 4) * 4, 128), dtype=np.uint32)  # zero loads
    padded[:c] = words
    lanes_words = padded.reshape(-1, 32, 4)  # [chunk][lane][i]
    part = np.zeros(lanes_words.shape[:2], dtype=np.uint32)
    for i in range(4):
        x = lanes_words[:, :, i]
        for p in range(4):
            y = x << np.uint32(7) if p == 0 else x >> np.uint32(8 * p - 7)
            k = i * 4 + p
            even = (k << 11) + ((y & np.uint32(0x780)) | lane4)
            odd = 8192 * 4 + (k << 7) + ((y & np.uint32(0x7800)) | lane4)
            part ^= smem[even >> 2] ^ smem[odd >> 2]
    crc = butterfly(part)[:c]
    assert (crc == crc[:, :1]).all()  # every lane holds the chunk's CRC
    return crc[:, 0] ^ np.uint32(inv ^ 0xFFFFFFFF)


def apply_op(tab, word):
    """The kernel's apply_op on a warp-uniform word, per tile: lane l looks
    up nibble l % 8, shuffles at offsets 1, 2, 4 combine a group of 8."""
    j = LANES & 7
    e = tab[j, _nib(word[..., None], j)]
    for off in (1, 2, 4):
        e = e ^ e[..., LANES ^ off]
    assert (e == e[..., :1]).all()
    return e[..., 0]


def emulate_blocks(words, nblocks, wcontrib, inv, ops, from_fold):
    """The fused kernel: (nblocks * cpb, 128) -> (nblocks,)."""
    crc = emulate_chunks(words, wcontrib, inv).reshape(nblocks, -1)
    cpb = crc.shape[1]
    tpb = -(-cpb // 32)
    nadv = (tpb - 1).bit_length()
    # Lane k of tile t holds the chunk at distance d = 32t + k from the end.
    dist = 32 * np.arange(tpb)[:, None] + LANES[None, :]
    mine = np.where(dist < cpb, crc[:, np.clip(cpb - 1 - dist, 0, None)], 0) \
        .astype(np.uint32)  # (nblocks, tpb, 32)
    ltab = lane_tables(ops, from_fold, cpb)
    applied = np.zeros_like(mine)
    for j in range(8):
        applied ^= ltab[j, _nib(mine, j), LANES]
    word = butterfly(applied)[..., 0]  # (nblocks, tpb)
    adv = advance_tables(ops, from_fold, cpb, nadv)
    t = np.arange(tpb)
    for q in range(nadv):
        word = np.where((t >> q) & 1, apply_op(adv[q], word), word)
    return np.bitwise_xor.reduce(word, axis=1).astype(np.uint32)


# ------------------------------------------------------------------ tests


def test_compact_operators_are_rows_of_the_fold_table():
    ops = port.fold_ops()
    for n in (33, 5000):
        fold = ref_checksum.combine_fold_table(512, n)
        for d in range(32):
            np.testing.assert_array_equal(ops[d], fold[n - 1 - d])
        for q in range(((n - 1) // 32).bit_length()):
            np.testing.assert_array_equal(ops[32 + q], fold[n - 1 - (32 << q)])


def test_chunk_tables_from_reference_wcontrib():
    ours = chunk_tables(port.word_contrib_table())
    np.testing.assert_array_equal(ours, chunk_tables(ref.word_contrib_table()))
    # Entry v = 1 << b is WCONTRIB's own column: the tables are that table.
    wc = ref.word_contrib_table()
    for i, j, b, lane in ((0, 0, 0, 0), (3, 7, 3, 31), (2, 5, 1, 17)):
        assert ours[i, j, 1 << b, lane] == wc[4 * j + b, 4 * lane + i]


@pytest.mark.parametrize("c", [1, 31, 32, 33, 257, 4096])
def test_emulated_chunk_kernel_matches_reference(c):
    words = _words((c, 128), c)
    got = emulate_chunks(words, port.word_contrib_table(), port.inv_contrib())
    want = np.asarray(ref.crc32c_chunks_device(jnp.asarray(words),
                                               use_pallas=False))
    np.testing.assert_array_equal(got, want)
    if c <= 257:  # Pallas interpret mode is slow on the CPU
        np.testing.assert_array_equal(got, np.asarray(ref.crc32c_chunks_device(
            jnp.asarray(words), use_pallas=True)))
    np.testing.assert_array_equal(got, u32_to_numpy(
        port.crc32c_chunks_device(host_to_device(words, CPU))))


@pytest.mark.parametrize("nblocks", [1, 3, 8])
@pytest.mark.parametrize("cpb", [1, 33, 257, 4096])
def test_emulated_fused_kernel_matches_reference(nblocks, cpb):
    words = _words((nblocks * cpb, 128), cpb + nblocks)
    wc, inv = port.word_contrib_table(), port.inv_contrib()
    got = emulate_blocks(words, nblocks, wc, inv, port.fold_ops(), False)
    want = np.asarray(ref.batch_block_crc_device(jnp.asarray(words),
                                                 nblocks))
    np.testing.assert_array_equal(got, want)
    # The operators taken from a fold table drive the same words.
    fold = ref_checksum.combine_fold_table(512, cpb)
    np.testing.assert_array_equal(
        emulate_blocks(words, nblocks, wc, inv, fold, True), want)
    # And the port's plain twin (the CPU path of the wrapper) agrees.
    np.testing.assert_array_equal(u32_to_numpy(port.crc32c_blocks_device(
        host_to_device(words, CPU), nblocks)), want)


def test_emulated_fused_kernel_on_bytes_is_the_stored_block_crc():
    data = np.random.default_rng(11).integers(0, 256, 3 * 70 * 512,
                                              dtype=np.uint8).tobytes()
    words = port.bytes_to_words(data)
    got = emulate_blocks(words, 3, ref.word_contrib_table(), ref.inv_contrib(),
                         combine_fold_table(512, 70), True)
    assert [int(x) for x in got] == [ref_checksum.crc32c(data[i:i + 70 * 512])
                                     for i in range(0, len(data), 70 * 512)]


def test_blocks_wrapper_rejects_what_the_kernel_does_not_take():
    words = host_to_device(_words((10, 128), 1), CPU)
    with pytest.raises(ValueError, match="split"):
        port.crc32c_blocks_device(words, 3)
    with pytest.raises(ValueError, match="fold"):
        port.crc32c_blocks_device(words, 2, fold=host_to_device(
            combine_fold_table(512, 4), CPU))
    with pytest.raises(ValueError, match="uint32 words"):
        port.crc32c_blocks_device(words.view(torch.int32), 2)
    assert port.crc32c_blocks_device(words[:0], 4).numel() == 4


def test_cpu_blocks_path_counts_no_launch():
    before = port.crc32c_blocks_device.launches
    port.block_crc_device(host_to_device(_words((4, 128), 2), CPU))
    port.batch_block_crc_device(host_to_device(_words((4, 128), 2), CPU), 2)
    assert port.crc32c_blocks_device.launches == before
