"""Port parity for WebDataset shards on DFS: ``tpudfs_torch.gpu.wds``
against the JAX package's ``tpudfs.tpu.wds`` on the reference
``MiniCluster`` — the same tar bytes from both writers, the same sample
per index from both sources (and from the port's source over its own
``LocalClient``), and ``tests/test_wds_train.py``'s three cases on the
port, the training loop with torch SGD in place of JAX's."""

import asyncio
import functools

import numpy as np
import pytest
import torch

from tests.test_master_service import MiniCluster
from tpudfs.client.client import Client
from tpudfs.tpu import wds as ref
from tpudfs_torch.client.local import LocalClient
from tpudfs_torch.gpu import wds as port

FEATURES = 32
CLASSES = 4
SAMPLES = 512
BATCH = 64


def _make_samples(rng, centers):
    for i in range(SAMPLES):
        cls = int(rng.integers(0, CLASSES))
        x = (centers[cls] + 0.3 * rng.normal(size=FEATURES)).astype(
            np.float32)
        yield {"__key__": f"{i:06d}", "img": x.tobytes(),
               "cls": str(cls).encode()}


async def _cluster(tmp_path):
    c = MiniCluster(tmp_path, n_masters=1, n_cs=3)
    await c.start()
    leader = await c.leader()
    await c.wait_out_of_safe_mode(leader)
    client = Client(list(c.masters), rpc_client=c.client,
                    block_size=64 * 1024)
    return c, client


def _factory(c):
    return functools.partial(Client, list(c.masters), block_size=64 * 1024)


async def _local_factory(c, client, paths):
    stores = {cs.address: (cs.store.hot_dir, cs.store.cold_dir)
              for cs in c.chunkservers}
    metas = {p: await client.get_file_info(p) for p in paths}
    return functools.partial(LocalClient, stores, metas)


async def test_wds_training_loop_learns(tmp_path):
    rng = np.random.default_rng(42)
    centers = rng.normal(size=(CLASSES, FEATURES)).astype(np.float32) * 2.0
    c, client = await _cluster(tmp_path)
    try:
        shards = await port.write_wds_shards(
            client, "/wds/train", _make_samples(rng, centers),
            shard_size_bytes=96 * 1024)
        assert len(shards) >= 2, "want a multi-shard dataset"

        def run_training():
            source = port.DfsWdsSource(_factory(c), shards)
            ref_source = ref.DfsWdsSource(list(c.masters), shards)
            try:
                assert len(source) == len(ref_source) == SAMPLES
                for i in (0, 1, 255, SAMPLES - 1):
                    assert source[i] == ref_source[i]
                s0 = source[0]
                assert s0["__key__"] == "000000"
                x0, y0 = port.decode_sample(s0, image_shape=(FEATURES,))
                rx0, ry0 = ref.decode_sample(s0, image_shape=(FEATURES,))
                np.testing.assert_array_equal(x0, rx0)
                assert y0 == ry0 and y0.dtype == np.int32

                def collate(samples):
                    xs, ys = zip(*(port.decode_sample(
                        s, image_shape=(FEATURES,)) for s in samples))
                    return torch.from_numpy(np.stack(xs)), \
                        torch.from_numpy(np.stack(ys)).long()

                loader = torch.utils.data.DataLoader(
                    source, batch_size=BATCH, shuffle=True,
                    generator=torch.Generator().manual_seed(7),
                    collate_fn=collate)
                torch.manual_seed(0)
                model = torch.nn.Sequential(
                    torch.nn.Linear(FEATURES, 64, bias=False),
                    torch.nn.ReLU(),
                    torch.nn.Linear(64, CLASSES, bias=False))
                opt = torch.optim.SGD(model.parameters(), lr=0.3)
                first = last = None
                for _epoch in range(6):
                    for x, y in loader:
                        loss = torch.nn.functional.cross_entropy(model(x), y)
                        opt.zero_grad()
                        loss.backward()
                        opt.step()
                        first = loss.item() if first is None else first
                        last = loss.item()
                correct = total = 0
                with torch.no_grad():
                    for x, y in loader:
                        correct += int((model(x).argmax(-1) == y).sum())
                        total += len(y)
                return first, last, correct, total
            finally:
                source.close()
                ref_source.close()

        first, last, correct, total = await asyncio.to_thread(run_training)
        assert first is not None and last < first / 3, (first, last)
        assert correct / total > 0.9, f"accuracy {correct}/{total}"
    finally:
        await c.stop()


async def test_wds_writer_validation_and_multipart_ext(tmp_path):
    c, client = await _cluster(tmp_path)
    try:
        with pytest.raises(ValueError, match="must not contain"):
            await port.write_wds_shards(client, "/wds/bad",
                                        [{"__key__": "a.b", "img": b"x"}])
        with pytest.raises(ValueError, match="USTAR"):
            await port.write_wds_shards(client, "/wds/bad2",
                                        [{"__key__": "k" * 101, "img": b"x"}])
        samples = [
            {"__key__": "000", "img": b"A" * 100, "seg.png": b"B" * 50},
            {"__key__": "001", "img": b"C" * 100, "seg.png": b"D" * 50},
        ]
        shards = await port.write_wds_shards(client, "/wds/mp", samples)
        ref_shards = await ref.write_wds_shards(client, "/wds/mpref", samples)
        assert len(shards) == len(ref_shards) == 1
        assert await client.get_file(shards[0]) == \
            await client.get_file(ref_shards[0])

        def check():
            source = port.DfsWdsSource(_factory(c), shards)
            try:
                assert len(source) == 2
                s0, s1 = source[0], source[1]
                assert s0["__key__"] == "000" and s0["seg.png"] == b"B" * 50
                assert s1["__key__"] == "001" and s1["img"] == b"C" * 100
            finally:
                source.close()

        await asyncio.to_thread(check)
    finally:
        await c.stop()


async def test_wds_shards_on_ec_files(tmp_path):
    """Shards stored erasure-coded (RS(2,1)) read back sample-exact, through
    the reference client and through the port's ``LocalClient``."""
    c, client = await _cluster(tmp_path)
    try:
        rng = np.random.default_rng(5)
        payloads = [rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
                    for _ in range(40)]
        shards = await port.write_wds_shards(
            client, "/wds/ec",
            ({"__key__": f"{i:06d}", "img": p, "cls": b"1"}
             for i, p in enumerate(payloads)),
            shard_size_bytes=48 * 1024, ec=(2, 1))
        meta = await client.get_file_info(shards[0])
        assert meta["blocks"][0].get("ec_data_shards") == 2  # really EC
        local = await _local_factory(c, client, shards)

        def check():
            for factory in (_factory(c), local):
                source = port.DfsWdsSource(factory, shards)
                try:
                    assert len(source) == len(payloads)
                    for i in (0, 7, len(payloads) - 1):
                        s = source[i]
                        assert s["__key__"] == f"{i:06d}"
                        assert s["img"] == payloads[i]
                finally:
                    source.close()

        await asyncio.to_thread(check)
    finally:
        await c.stop()
