"""Port parity for CRC32C: ``tpudfs_torch.gpu.crc32c_cuda`` (plain PyTorch
twin on the CPU) against the JAX reference ``tpudfs.tpu.crc32c_pallas``,
run both through its jnp fallback and through its Pallas kernel in
interpret mode, and against the host codec ``tpudfs.common.checksum``.
All functions are integer functions: equality is exact, no tolerance.
Inputs are made with numpy from a seed and handed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudfs.common import checksum as ref_checksum
from tpudfs.tpu import crc32c_pallas as ref
from tpudfs_torch.common import checksum as port_checksum
from tpudfs_torch.gpu import host_to_device, u32_to_numpy
from tpudfs_torch.gpu import crc32c_cuda as port
from tpudfs_torch.gpu import state

CPU = torch.device("cpu")


def _rand(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _words(data):
    return host_to_device(port.bytes_to_words(data), CPU)


def _u32(t) -> int:
    return int(u32_to_numpy(t.reshape(1))[0])


def _host(t) -> np.ndarray:
    return u32_to_numpy(t) if t.dtype == torch.uint32 else t.numpy()



# ------------------------------------------------------------ own tables


@pytest.mark.parametrize("n", [1, 300, 512])
def test_contrib_table_copy_equals_reference(n):
    got_rows, got_inv = port_checksum.contrib_table(n)
    want_rows, want_inv = ref_checksum.contrib_table(n)
    np.testing.assert_array_equal(got_rows, want_rows)
    assert got_inv == want_inv


def test_word_table_and_inv_equal_reference():
    np.testing.assert_array_equal(port.word_contrib_table(),
                                  ref.word_contrib_table())
    assert port.inv_contrib() == ref.inv_contrib()


@pytest.mark.parametrize("n", [1, 2, 16, 257])
def test_combine_fold_table_copy_equals_reference(n):
    np.testing.assert_array_equal(port_checksum.combine_fold_table(512, n),
                                  ref_checksum.combine_fold_table(512, n))


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 100_003])
def test_host_crc_copy_equals_reference(n):
    data = _rand(n, seed=n % 89)
    assert port_checksum.crc32c(data) == ref_checksum.crc32c(data)
    assert port_checksum.crc32c(data, 0xDEADBEEF) == \
        ref_checksum.crc32c(data, 0xDEADBEEF)
    np.testing.assert_array_equal(port_checksum.crc32c_chunks(data),
                                  ref_checksum.crc32c_chunks(data))
    # The numpy twins, which the native library is held against.
    assert port_checksum.crc32c_plain(data, 0xDEADBEEF) == \
        ref_checksum.crc32c(data, 0xDEADBEEF)
    np.testing.assert_array_equal(port_checksum.crc32c_chunks_plain(data),
                                  ref_checksum.crc32c_chunks(data))
    half = n // 2
    a, b = data[:half], data[half:]
    assert port_checksum.crc32c_combine(
        ref_checksum.crc32c(a), ref_checksum.crc32c(b), len(b)
    ) == ref_checksum.crc32c(data)


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("n", [512, 4096, 100_000, 1 << 20])
def test_crc_kernel_bit_exact(n):
    data = _rand(n, seed=n)
    want = ref_checksum.crc32c_chunks(data + b"\x00" * (-n % 512))
    got = port.crc32c_chunks_torch(data, device=CPU)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref.crc32c_chunks_jax(data, use_pallas=False))
    np.testing.assert_array_equal(got, ref.crc32c_chunks_jax(data, use_pallas=True))


def test_crc_plain_twin_on_raw_words():
    """Arbitrary word grids (not just byte strings) against the reference's
    jnp fallback and Pallas interpret mode."""
    words = np.random.default_rng(7).integers(0, 1 << 32, (300, 128),
                                              dtype=np.uint32)
    got = u32_to_numpy(port.crc32c_chunks_device(host_to_device(words, CPU)))
    for use_pallas in (False, True):
        want = np.asarray(ref.crc32c_chunks_device(jnp.asarray(words),
                                                   use_pallas=use_pallas))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [512, 64 * 1024, 1 << 20])
def test_block_crc_device_matches_host(n):
    data = _rand(n, seed=n % 97)
    words = _words(data)
    got = _u32(port.block_crc_device(words))
    assert got == ref_checksum.crc32c(data)
    assert got == int(np.asarray(ref.block_crc_device(jnp.asarray(
        ref.bytes_to_words(data)))))


def test_block_crc_device_empty():
    empty = torch.zeros((0, 128), dtype=torch.int32).view(torch.uint32)
    assert _u32(port.block_crc_device(empty)) == 0
    assert int(np.asarray(ref.block_crc_device(jnp.zeros((0, 128), jnp.uint32)))) == 0


@pytest.mark.parametrize("nblocks", [1, 3, 8])
def test_batch_block_crc_device_bit_exact(nblocks):
    cpb = 16
    datas = [_rand(cpb * 512, seed=40 + i) for i in range(nblocks)]
    joined = b"".join(datas)
    got = u32_to_numpy(port.batch_block_crc_device(_words(joined), nblocks))
    assert [int(x) for x in got] == [ref_checksum.crc32c(d) for d in datas]
    want = np.asarray(ref.batch_block_crc_device(
        jnp.asarray(ref.bytes_to_words(joined)), nblocks))
    np.testing.assert_array_equal(got, want)


def test_verify_block_device():
    data = _rand(8 * 512, seed=3)
    words = _words(data)
    good = host_to_device(ref_checksum.crc32c_chunks(data), CPU)
    assert bool(port.verify_block_device(words, good))
    bad = ref_checksum.crc32c_chunks(data)
    bad[5] ^= 1
    assert not bool(port.verify_block_device(words, host_to_device(bad, CPU)))


def test_bytes_to_words_layout_and_writability():
    for n in (0, 1, 511, 512, 4096, 5000):
        data = _rand(n, seed=n)
        got = port.bytes_to_words(data)
        np.testing.assert_array_equal(got, ref.bytes_to_words(data))
        assert got.flags.writeable
    buf = bytearray(_rand(1024, seed=1))
    view = port.bytes_to_words(buf)
    assert np.shares_memory(view, np.frombuffer(buf, dtype=np.uint8))


def test_wrapper_rejects_bad_input_and_cuda_default_without_card():
    with pytest.raises(ValueError):
        port.crc32c_chunks_device(torch.zeros((4, 64), dtype=torch.int32)
                                  .view(torch.uint32))
    with pytest.raises(ValueError):
        port.crc32c_chunks_device(torch.zeros((4, 128), dtype=torch.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.crc32c_chunks_torch(b"x" * 512)


def test_cpu_path_counts_no_launch():
    before = port.crc32c_chunks_device.launches
    port.crc32c_chunks_torch(_rand(2048), device=CPU)
    assert port.crc32c_chunks_device.launches == before


# ------------------------------------------------------- state carried over


def test_state_from_reference_equals_own_and_drives_same_results():
    cpb = 16
    ref_arrays = {
        "word_contrib_table": ref.word_contrib_table(),
        "inv_contrib": np.uint32(ref.inv_contrib()),
        f"combine_fold_table/{cpb}": ref_checksum.combine_fold_table(512, cpb),
    }
    theirs = state.from_reference(ref_arrays, CPU)
    ours = state.own_tables(ref_arrays, CPU)
    assert theirs.keys() == ours.keys()
    for key in theirs:
        np.testing.assert_array_equal(_host(theirs[key]), _host(ours[key]),
                                      err_msg=key)
    data = _rand(cpb * 512, seed=9)
    words = _words(data)
    results = []
    for tables in (theirs, ours):
        chunks = port.crc32c_chunks_device(
            words, tables["word_contrib_table"], tables["inv_contrib"])
        block = port.block_crc_device(
            words, wcontrib=tables["word_contrib_table"],
            inv=tables["inv_contrib"],
            fold=tables[f"combine_fold_table/{cpb}"])
        results.append((u32_to_numpy(chunks), _u32(block)))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(results[0][0], ref_checksum.crc32c_chunks(data))
    assert results[0][1] == results[1][1] == ref_checksum.crc32c(data)


def test_state_from_reference_rejects_wrong_shape():
    with pytest.raises(ValueError):
        state.from_reference({"word_contrib_table": np.zeros((16, 128))}, CPU)
    with pytest.raises(KeyError):
        state.from_reference({"no_such_table": np.zeros(1)}, CPU)
