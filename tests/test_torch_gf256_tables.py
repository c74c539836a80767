"""The GF(2^8) kernel's arithmetic, emulated on the CPU and held bit-exact
against the JAX package.

``csrc/gf256.cu`` derives, in its prologue, a 16-entry nibble table per
input row, nibble half and group of four output rows from the (rows, cols, 8)
bit-planes its wrapper passes: byte r of ``T[c][g][h][n]`` is the XOR of
``bits[4g+r][c][4h+j]`` over the set bits j of n. This file builds the same
tables on the host, laid out as the kernel's shared memory, and runs the
kernel's steps in numpy: per input word and byte position the low and high
nibble lookups of every row group (the number of groups per pass as the
kernel's dispatch picks it, the input read again per pass above 16 rows),
XOR-ed in pairs into the accumulators, then the 4x4 byte transpose of eight
``__byte_perm`` into row words. The results are compared with the
reference's ``_parity_rows`` (jnp) and ``gf_matmul_device`` (jnp and Pallas
interpret mode), and with the port's plain twin. Exact integer functions:
no tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudfs.common import erasure as ref_erasure
from tpudfs.tpu import rs_pallas as ref
from tpudfs_torch.gpu import host_to_device, state, u32_to_numpy
from tpudfs_torch.gpu import rs_cuda as port
from tests.test_torch_rs import DECODE_CASES

CPU = torch.device("cpu")
MAX_GROUPS = 4  # gf256.cu's kMaxGroups: row groups per pass


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, shape, dtype=np.uint32)


def groups_per_pass(rows):
    """The kernel's template dispatch: G = ceil(rows / 4), at most 4."""
    return min(-(-rows // 4), MAX_GROUPS)


def table_groups(rows, g):
    """Row groups with tables: ceil(rows / 4), rounded up to a multiple of g."""
    return -(-(-(-rows // 4)) // g) * g


def nibble_tables(bits, ngroups):
    """(cols, ngroups, 2, 16) uint32, the kernel's [col][group][half][16]."""
    rows, cols, _ = bits.shape
    planes = np.zeros((4 * ngroups, cols, 8), dtype=np.uint32)
    planes[:rows] = np.asarray(bits, dtype=np.uint32) & np.uint32(0xFF)
    per_row = np.zeros((4 * ngroups, cols, 2, 16), dtype=np.uint32)
    for n in range(16):
        for j in range(4):
            if n >> j & 1:
                per_row[:, :, :, n] ^= planes[:, :, [j, 4 + j]]
    per_row = per_row.reshape(ngroups, 4, cols, 2, 16)
    packed = np.zeros((ngroups, cols, 2, 16), dtype=np.uint32)
    for r in range(4):
        packed |= per_row[:, r] << np.uint32(8 * r)
    return packed.transpose(1, 0, 2, 3)


def shared_memory(bits):
    """The words the kernel's prologue writes: word t holds n = t & 15,
    h = (t >> 4) & 1, g = (t >> 5) % ngroups, c = (t >> 5) // ngroups."""
    rows, cols, _ = bits.shape
    ngroups = table_groups(rows, groups_per_pass(rows))
    smem = np.zeros(cols * ngroups * 32, dtype=np.uint32)
    tab = nibble_tables(bits, ngroups)
    for t in range(smem.size):
        n, h = t & 15, (t >> 4) & 1
        g, c = (t >> 5) % ngroups, (t >> 5) // ngroups
        smem[t] = tab[c, g, h, n]
    return smem


def byte_perm(a, b, sel):
    """CUDA's __byte_perm(a, b, sel) for selectors 0..7: byte k of the
    result is byte (sel >> 4k) & 7 of the 8 bytes b:a."""
    both = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    out = np.zeros(a.shape, dtype=np.uint64)
    for k in range(4):
        s = (sel >> (4 * k)) & 7
        out |= ((both >> np.uint64(8 * s)) & np.uint64(0xFF)) << np.uint64(8 * k)
    return out.astype(np.uint32)


def transpose4(a, b, c, d):
    ab01, ab23 = byte_perm(a, b, 0x5140), byte_perm(a, b, 0x7362)
    cd01, cd23 = byte_perm(c, d, 0x5140), byte_perm(c, d, 0x7362)
    return (byte_perm(ab01, cd01, 0x5410), byte_perm(ab01, cd01, 0x7632),
            byte_perm(ab23, cd23, 0x5410), byte_perm(ab23, cd23, 0x7632))


def emulate(words, bits):
    """The kernel: (cols, W) words, (rows, cols, 8) bit-planes -> (rows, W)."""
    rows, cols, _ = bits.shape
    g_pass = groups_per_pass(rows)
    ngroups = table_groups(rows, g_pass)
    smem = shared_memory(bits)
    out = np.zeros((rows, words.shape[1]), dtype=np.uint32)
    for g0 in range(0, ngroups, g_pass):
        acc = np.zeros((g_pass, 4, words.shape[1]), dtype=np.uint32)
        for c in range(cols):
            x = words[c]
            base = (c * ngroups + g0) * 32
            for p in range(4):
                lo = (x >> np.uint32(8 * p)) & np.uint32(15)
                hi = (x >> np.uint32(8 * p + 4)) & np.uint32(15)
                for g in range(g_pass):
                    acc[g, p] ^= smem[base + g * 32 + lo] \
                        ^ smem[base + g * 32 + 16 + hi]
        for g in range(g_pass):
            for r, row in enumerate(transpose4(*acc[g])):
                if 4 * (g0 + g) + r < rows:
                    out[4 * (g0 + g) + r] = row
    return out


def _ref_gf(mat, words, use_pallas):
    """The reference's gf_matmul_device on the words' bytes, as words."""
    shards = jnp.asarray(np.ascontiguousarray(words).view(np.uint8))
    out = ref.gf_matmul_device(mat, shards, use_pallas=use_pallas)
    return np.ascontiguousarray(np.asarray(out)).view(np.uint32)


def _check(mat, words, pallas=True):
    bits = port._matrix_bits(mat)
    got = emulate(words, bits)
    np.testing.assert_array_equal(got, np.asarray(ref._parity_rows(
        jnp.asarray(words), ref._matrix_bits(
            tuple(int(x) for x in mat.flatten()), *mat.shape))))
    for use_pallas in (False, True) if pallas else (False,):
        np.testing.assert_array_equal(got, _ref_gf(mat, words, use_pallas))
    np.testing.assert_array_equal(got, u32_to_numpy(port.gf_matmul_words(
        host_to_device(words, CPU), host_to_device(bits, CPU))))


# ------------------------------------------------------------------ tests


def test_tables_hold_the_bit_planes_and_are_linear():
    bits = port._matrix_bits(port.decode_matrix(6, 3, (1, 3, 4, 5, 6, 8)))
    tab = nibble_tables(bits, 2)
    for c, g, h, j, r in ((0, 0, 0, 0, 0), (5, 1, 1, 3, 1), (2, 0, 1, 2, 3)):
        byte = tab[c, g, h, 1 << j] >> np.uint32(8 * r) & np.uint32(0xFF)
        assert byte == bits[4 * g + r, c, 4 * h + j]
    for n in range(16):
        for m in range(16):
            np.testing.assert_array_equal(tab[..., n ^ m],
                                          tab[..., n] ^ tab[..., m])
    # Rows 6 and 7 of the second group do not exist: their bytes are zero.
    assert not (tab[:, 1] >> np.uint32(16)).any()


def test_byte_transpose_moves_rows_into_words():
    src = _words((4, 64), 7)
    rows = transpose4(*src)
    as_bytes = np.stack([s.view(np.uint8).reshape(-1, 4) for s in src], axis=1)
    for r in range(4):
        np.testing.assert_array_equal(rows[r].view(np.uint8).reshape(-1, 4),
                                      as_bytes[:, :, r])


@pytest.mark.parametrize("w", [1, 3, 4, 2047])
@pytest.mark.parametrize("k,m", [(4, 2), (6, 3), (10, 4)])
def test_emulated_kernel_encode_matches_reference(k, m, w):
    _check(ref_erasure.encode_matrix(k, m)[k:], _words((k, w), k * w))


@pytest.mark.parametrize("w", [3, 2047])
@pytest.mark.parametrize("k,m,missing", DECODE_CASES)
def test_emulated_kernel_decode_matches_reference(k, m, missing, w):
    present = tuple(i for i in range(k + m) if i not in missing)
    _check(ref.decode_matrix(k, m, present[:k]), _words((k, w), w + k))


@pytest.mark.parametrize("rows,cols", [(1, 1), (5, 9), (17, 3), (33, 2)])
def test_emulated_kernel_any_shape_and_passes(rows, cols):
    """One row, odd groups, and more than 16 rows (two and three passes
    over the input, groups rounded up to a multiple of 4); Pallas interpret
    mode is left out here for its compile time on the CPU."""
    mat = np.random.default_rng(rows * cols).integers(0, 256, (rows, cols),
                                                      dtype=np.uint8)
    _check(mat, _words((cols, 37), rows), pallas=False)


def test_emulated_kernel_on_reference_bit_planes():
    """Bit-planes carried across with ``state.from_reference`` drive the
    kernel's tables to the reference's result."""
    k, m, missing = 6, 3, (0, 2, 7)
    present = tuple(i for i in range(k + m) if i not in missing)
    dkey = f"decode_matrix/{k},{m}/{','.join(map(str, present))}"
    mat = ref.decode_matrix(k, m, present)
    theirs = state.from_reference({
        f"coef_bits/{k},{m}": np.asarray(ref.coef_bits(k, m), dtype=np.uint32),
        dkey: np.asarray(ref._matrix_bits(tuple(int(x) for x in mat.flatten()),
                                          k, k), dtype=np.uint32),
    }, CPU)
    words = _words((k, 2047), 99)
    for key, coefs in ((f"coef_bits/{k},{m}", ref.coef_bits(k, m)),
                       (dkey, ref._matrix_bits(
                           tuple(int(x) for x in mat.flatten()), k, k))):
        got = emulate(words, u32_to_numpy(theirs[key]))
        np.testing.assert_array_equal(got, np.asarray(ref._parity_rows(
            jnp.asarray(words), coefs)))
