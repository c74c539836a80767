"""The port's hand-written CUDA kernels against their plain PyTorch twins,
on the card. Each test takes the ``cuda_device`` fixture and skips, with
its reason, on a host without a card: a CUDA kernel has no CPU or
interpret mode. This file imports neither jax nor ``tpudfs``, so it also
runs on a card host that has no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpudfs_torch.gpu import host_to_device, u32_to_numpy
from tpudfs_torch.gpu import crc32c_cuda, rs_cuda
from tpudfs_torch.gpu.hbm_reader import device_array_to_bytes

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


@pytest.mark.parametrize("w", [32, 2047, 65536])
def test_gf_kernel_matches_plain(cuda_device, w):
    words = _words((6, w), w)
    for bits in (rs_cuda.coef_bits(6, 3),
                 rs_cuda._matrix_bits(rs_cuda.decode_matrix(
                     6, 3, (1, 3, 4, 5, 6, 8)))):
        got = rs_cuda.gf_matmul_words(host_to_device(words, cuda_device),
                                      host_to_device(bits, cuda_device))
        want = rs_cuda.gf_matmul_words(host_to_device(words, CPU),
                                       host_to_device(bits, CPU))
        np.testing.assert_array_equal(u32_to_numpy(got), u32_to_numpy(want))


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
    assert r["launches"]["gf256_matmul"] > 0


def test_device_array_to_bytes_round_trip(cuda_device):
    data = np.random.default_rng(9).integers(0, 256, 5000, dtype=np.uint8)
    words = host_to_device(crc32c_cuda.bytes_to_words(data), cuda_device)
    assert device_array_to_bytes(words, 5000) == data.tobytes()
