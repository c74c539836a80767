"""Port parity for the training infeed: ``tpudfs_torch.gpu.infeed.DfsInfeed``
on the CPU device against the JAX reference's ``DfsInfeed``, on the same
files of an in-process ``MiniCluster``: the same files in order, every
block verified, the same bytes, and ``batch_words`` stacking them as the
reference does. Also the error hand-off and an early exit of the
synchronous iterator."""

import asyncio
import threading

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_hbm_reader import _cluster, _rand
from tpudfs.tpu import infeed as ref
from tpudfs_torch.client.local import DfsError, LocalClient
from tpudfs_torch.gpu import hbm_reader as port
from tpudfs_torch.gpu import infeed, u32_to_numpy

CPU = torch.device("cpu")


async def test_infeed_missing_file_raises(tmp_path):
    """A failed prefetch must raise to the consumer, never hang it."""
    c, client = await _cluster(tmp_path, [])
    try:
        feed = infeed.DfsInfeed(client, ["/no/such/file"], [CPU])

        async def consume():
            async for _ in feed.__aiter__():
                pass

        with pytest.raises(DfsError, match="file not found"):
            await asyncio.wait_for(consume(), timeout=30)
    finally:
        await c.stop()


async def test_infeed_stream(tmp_path):
    files = [(f"/in/f{i}", _rand(64 * 1024, seed=10 + i)) for i in range(3)]
    c, client = await _cluster(tmp_path, files)
    try:
        feed = infeed.DfsInfeed(client, [p for p, _ in files], [CPU],
                                prefetch=2)
        seen = []
        async for path, blocks in feed.__aiter__():
            seen.append(path)
            assert all(b.verified for b in blocks)
            joined = b"".join(port.device_array_to_bytes(b.array, b.size)
                              for b in blocks)
            assert joined == dict(files)[path]
        assert seen == [p for p, _ in files]
    finally:
        await c.stop()


async def test_infeed_matches_reference(tmp_path):
    """Both packages' prefetchers over the same files (one with an
    unaligned tail block), and batch_words of the full blocks. The
    synchronous iterator runs its own event loop and is exercised on the
    colocated client below (the cluster's gRPC client belongs to this
    test's loop)."""
    files = [("/ip/a", _rand(4 * 64 * 1024, seed=20)),
             ("/ip/b", _rand(64 * 1024 + 3000, seed=21))]
    c, client = await _cluster(tmp_path, files)
    try:
        paths = [p for p, _ in files]
        mine = [item async for item in
                infeed.DfsInfeed(client, paths, [CPU]).__aiter__()]
        want = [item async for item in
                ref.DfsInfeed(client, paths, jax.devices()[:1]).__aiter__()]
        assert [p for p, _ in mine] == [p for p, _ in want] == paths
        for (path, blocks), (_, theirs), (_, data) in zip(mine, want, files):
            assert [b.verified for b in blocks] == \
                [b.verified for b in theirs]
            assert all(b.verified for b in blocks)
            assert b"".join(port.device_array_to_bytes(b.array, b.size)
                            for b in blocks) == data
        stacked = infeed.batch_words(mine[0][1])
        assert stacked.dtype == torch.uint32 and stacked.shape == (4, 128, 128)
        np.testing.assert_array_equal(u32_to_numpy(stacked),
                                      np.asarray(ref.batch_words(want[0][1])))
    finally:
        await c.stop()


def test_infeed_sync_iterator_early_exit_and_error(tmp_path):
    """The synchronous iterator over a colocated client yields every file
    verified and exact; breaking out of it stops its producer thread; an
    error in the producer reaches the consumer."""
    import chip_smoke

    stores, metas, sources = chip_smoke.lay_out(
        tmp_path, np.random.default_rng(1), block_size=16 * 1024, nblocks=3,
        tail_size=5000, ec=(6, 3), lost=(0, 2, 7))
    client = LocalClient(stores, metas)
    threads = threading.active_count()
    seen = [(path, len(blocks), all(b.verified for b in blocks),
             b"".join(port.device_array_to_bytes(b.array, b.size)
                      for b in blocks) == sources[path].tobytes())
            for path, blocks in infeed.DfsInfeed(
                client, ["/smoke/big", "/smoke/tail"], [CPU])
            .as_sync_iterator()]
    assert seen == [("/smoke/big", 3, True, True),
                    ("/smoke/tail", 1, True, True)]
    feed = infeed.DfsInfeed(client, ["/smoke/big", "/smoke/tail"] * 4,
                            [CPU], prefetch=1)
    for path, blocks in feed.as_sync_iterator():
        assert path == "/smoke/big" and len(blocks) == 3
        break
    for _ in range(100):
        if threading.active_count() <= threads:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= threads
    with pytest.raises(DfsError, match="file not found"):
        list(infeed.DfsInfeed(client, ["/smoke/big", "/nope"],
                              [CPU]).as_sync_iterator())
