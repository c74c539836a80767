"""Port parity for Reed-Solomon / GF(2^8): ``tpudfs_torch.gpu.rs_cuda``
(plain PyTorch twin on the CPU) against the JAX reference
``tpudfs.tpu.rs_pallas``, run through its jnp fallback and through its
Pallas kernel in interpret mode, and against the host codec
``tpudfs.common.erasure``. Exact equality: these are integer functions.
Inputs are made with numpy from a seed and handed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudfs.common import erasure as ref_erasure
from tpudfs.tpu import rs_pallas as ref
from tpudfs_torch.common import erasure as port_erasure
from tpudfs_torch.gpu import host_to_device, u32_to_numpy
from tpudfs_torch.gpu import rs_cuda as port
from tpudfs_torch.gpu import state

CPU = torch.device("cpu")
DECODE_CASES = [
    (4, 2, (0,)),          # one data shard lost
    (6, 3, (1, 4)),        # two data shards lost
    (6, 3, (0, 5, 7)),     # two data + one parity lost
    (6, 3, (0, 2, 7)),     # the smoke run's pattern
    (6, 3, (6, 7, 8)),     # only parity lost (identity decode)
]


def _rand(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _ref_bits(mat) -> np.ndarray:
    """The reference's compile-time bit-plane constants of ``mat``."""
    rows, cols = mat.shape
    return np.asarray(ref._matrix_bits(tuple(int(x) for x in mat.flatten()),
                                       rows, cols), dtype=np.uint32)


def _stack(shards, use, slen):
    stack = np.zeros((len(use), port.pad_shard_len(slen)), dtype=np.uint8)
    for r, idx in enumerate(use):
        stack[r, :slen] = np.frombuffer(shards[idx], dtype=np.uint8)
    return stack



# ------------------------------------------------------------ own tables


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (6, 3), (10, 4)])
def test_erasure_copy_equals_reference(k, m):
    np.testing.assert_array_equal(port_erasure.encode_matrix(k, m),
                                  ref_erasure.encode_matrix(k, m))
    for a, b in ((0, 7), (3, 200), (255, 255), (29, 1)):
        assert port_erasure.gf_mul(a, b) == ref_erasure.gf_mul(a, b)
    for a in (1, 2, 29, 255):
        assert port_erasure.gf_inv(a) == ref_erasure.gf_inv(a)
    sub = ref_erasure.encode_matrix(k, m)[list(range(1, k + 1))]
    np.testing.assert_array_equal(port_erasure._matrix_invert(sub),
                                  ref_erasure._matrix_invert(sub))
    data = _rand(10_007, seed=k)
    assert port_erasure.encode(data, k, m) == ref_erasure.encode(data, k, m)
    assert port_erasure.shard_len(10_007, k) == ref_erasure.shard_len(10_007, k)


@pytest.mark.parametrize("k,m", [(4, 2), (6, 3)])
def test_coef_bits_and_decode_matrix_equal_reference(k, m):
    np.testing.assert_array_equal(port.coef_bits(k, m),
                                  np.asarray(ref.coef_bits(k, m)))
    present = tuple(range(1, k + m))
    np.testing.assert_array_equal(port.decode_matrix(k, m, present),
                                  ref.decode_matrix(k, m, present))
    assert port.pad_shard_len(1000) == ref.pad_shard_len(1000)


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("k,m", [(4, 2), (6, 3)])
def test_rs_kernel_bit_exact(k, m):
    data = _rand(100_000, seed=1)
    want = ref_erasure.encode(data, k, m)
    got = port.rs_encode_torch(data, k, m, device=CPU)
    assert got == want
    assert got == ref.rs_encode_jax(data, k, m, use_pallas=False)
    assert got == ref.rs_encode_jax(data, k, m, use_pallas=True)
    shards: list = list(got)
    shards[0] = None
    shards[k] = None
    assert ref_erasure.decode(shards, k, m, len(data)) == data


@pytest.mark.parametrize("k,m,missing", DECODE_CASES)
def test_rs_decode_device_bit_exact(k, m, missing):
    data = _rand(50_000, seed=11)
    shards = ref_erasure.encode(data, k, m)
    slen = len(shards[0])
    present = tuple(i for i in range(k + m) if i not in missing)
    use = present[:k]
    stack = _stack(shards, use, slen)
    out = port.rs_decode_device(host_to_device(stack, CPU), k, m, use).numpy()
    got = b"".join(out[i, :slen].tobytes() for i in range(k))[: len(data)]
    assert got == data
    for use_pallas in (False, True):
        want = np.asarray(ref.rs_decode_device(jnp.asarray(stack), k, m, use,
                                               use_pallas=use_pallas))
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("k,m", [(4, 2), (6, 3)])
def test_gf_matmul_runtime_bit_exact(k, m):
    rng = np.random.default_rng(50)
    shards = rng.integers(0, 256, (k, 1024), dtype=np.uint8)
    words = np.ascontiguousarray(shards).view("<u4")
    for mat in (ref_erasure.encode_matrix(k, m)[k:],
                ref.decode_matrix(k, m, tuple(range(1, k + 1)))):
        want = ref_erasure._gf_matmul(np.asarray(mat), shards)
        got = u32_to_numpy(port.gf_matmul_runtime(
            torch.from_numpy(np.array(mat)), host_to_device(words, CPU)))
        assert got.tobytes() == want.tobytes()
        ref_got = np.asarray(ref.gf_matmul_runtime(jnp.asarray(mat),
                                                   jnp.asarray(words)))
        np.testing.assert_array_equal(got, ref_got)


@pytest.mark.parametrize("w", [3, 2047])
def test_gf_plain_twin_matches_reference_parity_rows(w):
    """Ragged word counts through the plain twin and the reference's jnp
    and interpret-mode kernels (the CUDA kernel masks the same edge)."""
    words = np.random.default_rng(w).integers(0, 1 << 32, (6, w), dtype=np.uint32)
    got = u32_to_numpy(port.gf_matmul_words(
        host_to_device(words, CPU), host_to_device(port.coef_bits(6, 3), CPU)))
    want = np.asarray(ref._parity_rows(jnp.asarray(words), ref.coef_bits(6, 3)))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(ref._gf_pallas_fn(ref.coef_bits(6, 3), True)(
        jnp.asarray(words)))
    np.testing.assert_array_equal(got, pallas)


def test_gf_wrapper_rejects_bad_input():
    words = torch.zeros((6, 8), dtype=torch.int32).view(torch.uint32)
    bits = host_to_device(port.coef_bits(4, 2), CPU)  # expects 4 input rows
    with pytest.raises(ValueError):
        port.gf_matmul_words(words, bits)
    with pytest.raises(ValueError):
        port.gf_matmul_words(words.view(torch.int32),
                             host_to_device(port.coef_bits(6, 3), CPU))
    big = torch.zeros((64, 64, 8), dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="too large"):
        port.gf_matmul_words(
            torch.zeros((64, 8), dtype=torch.int32).view(torch.uint32), big)


# ------------------------------------------------------- state carried over


def test_state_from_reference_equals_own_and_drives_same_results():
    k, m, missing = 6, 3, (0, 2, 7)
    present = tuple(i for i in range(k + m) if i not in missing)
    dkey = f"decode_matrix/{k},{m}/{','.join(map(str, present))}"
    ref_arrays = {
        f"coef_bits/{k},{m}": np.asarray(ref.coef_bits(k, m), dtype=np.uint32),
        dkey: _ref_bits(ref.decode_matrix(k, m, present)),
    }
    theirs = state.from_reference(ref_arrays, CPU)
    ours = state.own_tables(ref_arrays, CPU)
    for key in ref_arrays:
        np.testing.assert_array_equal(u32_to_numpy(theirs[key]),
                                      u32_to_numpy(ours[key]), err_msg=key)
    data = _rand(30_000, seed=5)
    shards = ref_erasure.encode(data, k, m)
    slen = len(shards[0])
    stack = host_to_device(_stack(shards, range(k), slen), CPU)
    avail = host_to_device(_stack(shards, present[:k], slen), CPU)
    for tables in (theirs, ours):
        parity = port.rs_encode_device(stack, k, m,
                                       coefs=tables[f"coef_bits/{k},{m}"]).numpy()
        assert [parity[i, :slen].tobytes() for i in range(m)] == shards[k:]
        recon = port.rs_decode_device(avail, k, m, present,
                                      coefs=tables[dkey]).numpy()
        got = b"".join(recon[i, :slen].tobytes() for i in range(k))
        assert got[: len(data)] == data
