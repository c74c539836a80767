"""Port parity for the dataset infeed: ``tpudfs_torch.gpu.record_source``
(``DfsRecordSource``, ``make_dataset``, ``device_iterator``) and
``tpudfs_torch.gpu.torch_data.DfsTorchDataset`` against the JAX package's
``tpudfs.tpu.grain_infeed`` and ``tpudfs.tpu.torch_data``, on the reference
``MiniCluster`` and on the port's ``LocalClient`` over the same chunkserver
stores. Bit-exact: the bytes of every record index, the batches in order
without a shuffle seed, and the multiset of every epoch with one. Then the
training loops of ``tests/test_torch_interop.py`` and
``tests/test_train_e2e.py`` on the port (torch SGD in place of JAX SGD),
one checkpointing through the port's ``CheckpointManager``, one losing a
chunkserver mid-training."""

import asyncio
import functools
import pickle
from collections import Counter

import numpy as np
import pytest
import torch

from tests.test_master_service import MiniCluster
from tpudfs.client.client import Client
from tpudfs.common import resilience
from tpudfs.tpu import grain_infeed as gi
from tpudfs_torch.client.local import LocalClient
from tpudfs_torch.gpu import record_source as rs
from tpudfs_torch.gpu.checkpoint import CheckpointManager
from tpudfs_torch.gpu.hbm_reader import HbmReader
from tpudfs_torch.gpu.torch_data import DfsTorchDataset

CPU = torch.device("cpu")
RECORD = 48
BATCH = 8


async def _cluster(tmp_path, files, *, block_size=1024):
    c = MiniCluster(tmp_path, n_masters=1, n_cs=3)
    await c.start()
    leader = await c.leader()
    await c.wait_out_of_safe_mode(leader)
    client = Client(list(c.masters), rpc_client=c.client,
                    block_size=block_size)
    for path, data, *ec in files:
        await client.create_file(path, data, ec=ec[0] if ec else None)
    return c, client


def _factory(c, block_size=1024):
    return functools.partial(Client, list(c.masters), block_size=block_size)


async def _local_factory(c, client, paths):
    """A ``LocalClient`` over the cluster's own chunkserver stores (the
    same files, read off disk by the port)."""
    stores = {cs.address: (cs.store.hot_dir, cs.store.cold_dir)
              for cs in c.chunkservers}
    metas = {p: await client.get_file_info(p) for p in paths}
    return functools.partial(LocalClient, stores, metas)


def _files(seed: int):
    rng = np.random.default_rng(seed)
    # 3 files: a tail shorter than a record, a record-aligned file, an EC
    # file (2+1) whose records span its blocks.
    return [("/rec/a", rng.bytes(RECORD * 37 + 11)),
            ("/rec/b", rng.bytes(RECORD * 20)),
            ("/rec/c", rng.bytes(RECORD * 30 + 5), (2, 1))]


def _records(files) -> list[bytes]:
    out = []
    for _p, data, *_ in files:
        for off in range(0, len(data) - RECORD + 1, RECORD):
            out.append(data[off : off + RECORD])
    return out


async def test_record_bytes_per_index_match_reference(tmp_path):
    files = _files(1)
    c, client = await _cluster(tmp_path, files)
    try:
        paths = [f[0] for f in files]
        local = await _local_factory(c, client, paths)

        def check():
            ref = gi.DfsRecordSource(list(c.masters), paths, RECORD,
                                     dtype="uint16")
            sources = [rs.DfsRecordSource(_factory(c), paths, RECORD,
                                          dtype="uint16"),
                       rs.DfsRecordSource(local, paths, RECORD,
                                          dtype="uint16")]
            try:
                want = _records(files)
                assert len(ref) == len(want)
                for src in sources:
                    assert len(src) == len(want)
                    for i in range(len(want)):
                        got = src[i]
                        assert got.dtype == np.uint16
                        assert got.tobytes() == ref[i].tobytes() == want[i]
                # The source pickles without its client and rebuilds one.
                again = pickle.loads(pickle.dumps(sources[1]))
                assert again._cl is None
                assert again[len(want) - 1].tobytes() == want[-1]
                again.close()
            finally:
                ref.close()
                for src in sources:
                    src.close()

        await asyncio.to_thread(check)
    finally:
        await c.stop()


def test_record_source_validates_and_closes_on_failure(tmp_path):
    stores = {"cs0:7000": (tmp_path / "hot", None)}
    factory = functools.partial(LocalClient, stores, {})
    with pytest.raises(ValueError, match="positive"):
        rs.DfsRecordSource(factory, [], 0)
    with pytest.raises(ValueError, match="itemsize"):
        rs.DfsRecordSource(factory, [], 5, dtype="float32")
    with pytest.raises(FileNotFoundError, match="/missing"):
        rs.DfsRecordSource(factory, ["/missing"], 8)


def test_source_rebuilds_its_client_after_a_fork(tmp_path):
    """A source whose client was built in another process (a forked
    ``DataLoader`` worker inherits it, without its loop thread) builds a
    fresh one instead of waiting on a dead loop."""
    import chip_smoke

    data = np.random.default_rng(3).integers(0, 256, 4 * RECORD,
                                             dtype=np.uint8)
    stores, metas = chip_smoke.lay_out_shard(tmp_path, data, block_size=512,
                                             hot="/f/hot", cold="/f/ec")
    src = rs.DfsRecordSource(functools.partial(LocalClient, stores, metas),
                             ["/f/hot"], RECORD)
    inherited = src._cl
    src._cl_pid = -1  # as seen from a forked child
    try:
        assert src[3].tobytes() == data[3 * RECORD:].tobytes()
        assert src._cl is not inherited
    finally:
        inherited.close()
        src.close()


def _batches(loader) -> list[bytes]:
    return [b.numpy().tobytes() if isinstance(b, torch.Tensor)
            else np.asarray(b).tobytes() for b in loader]


def _epoch_counters(batches: list[bytes], per_epoch: int) -> list[Counter]:
    recs = [b[i : i + RECORD] for b in batches
            for i in range(0, len(b), RECORD)]
    return [Counter(recs[e : e + per_epoch])
            for e in range(0, len(recs), per_epoch)]


async def test_make_dataset_matches_grain_pipeline(tmp_path):
    """Without a seed: the same batches in the same order as grain's
    pipeline (epochs back to back, batches spanning them, the last partial
    one dropped). With a seed: a permutation, replayed by a second
    iteration."""
    files = _files(2)[:2]
    c, client = await _cluster(tmp_path, files)
    try:
        paths = [f[0] for f in files]

        def check():
            ref = gi.DfsRecordSource(list(c.masters), paths, RECORD)
            src = rs.DfsRecordSource(_factory(c), paths, RECORD)
            try:
                n = len(src)
                assert n % BATCH  # batches span the epoch boundary
                for epochs in (1, 3):
                    want = _batches(gi.make_dataset(
                        ref, batch_size=BATCH, num_epochs=epochs))
                    got = _batches(rs.make_dataset(
                        src, batch_size=BATCH, num_epochs=epochs,
                        device=CPU))
                    assert got == want
                    assert len(got) == epochs * n // BATCH
                loader = rs.make_dataset(src, batch_size=BATCH,
                                         shuffle_seed=3, device=CPU)
                got = _batches(loader)
                assert got == _batches(loader)
                assert got != want[: len(got)]
                [seen] = _epoch_counters(got, len(got) * BATCH)
                assert sum(seen.values()) == n - n % BATCH
                assert set(seen) <= set(_records(files))
                assert max(seen.values()) == 1
            finally:
                ref.close()
                src.close()

        await asyncio.to_thread(check)
    finally:
        await c.stop()


def test_local_client_read_meta_range(tmp_path):
    """The port's ``read_meta_range`` over its own stores: replicated and
    RS(3,2) files, healthy and with two shards of every EC block lost,
    ranges across blocks, clipped at the end and empty past it."""
    import chip_smoke

    data = np.random.default_rng(8).integers(0, 256, 10_000, dtype=np.uint8)
    stores, metas = chip_smoke.lay_out_shard(tmp_path, data, block_size=4096,
                                             hot="/r/hot", cold="/r/ec")
    client = LocalClient(stores, metas)
    want = data.tobytes()

    async def reads(path):
        meta = metas[path]
        return [await client.read_meta_range(meta, off, n)
                for off, n in ((0, 10_000), (4000, 200), (4095, 1),
                               (8190, 5000), (9999, 1), (10_000, 5),
                               (5, 0))]

    expect = [want, want[4000:4200], want[4095:4096], want[8190:],
              want[9999:], b"", b""]
    assert asyncio.run(reads("/r/hot")) == expect
    assert asyncio.run(reads("/r/ec")) == expect
    chip_smoke._drop_shards(client, metas["/r/ec"], (0, 3))
    assert asyncio.run(reads("/r/ec")) == expect
    chip_smoke._drop_shards(client, metas["/r/ec"], (1,))
    with pytest.raises(Exception, match="EC decode failed"):
        asyncio.run(reads("/r/ec"))


async def test_seeded_epochs_hold_the_reference_multisets(tmp_path):
    """Records a multiple of the batch: each epoch of the port's shuffled
    pipeline holds exactly the multiset of the reference's same epoch."""
    rng = np.random.default_rng(4)
    files = [("/ep/a", rng.bytes(RECORD * 40)), ("/ep/b", rng.bytes(RECORD * 24))]
    c, client = await _cluster(tmp_path, files)
    try:
        paths = [f[0] for f in files]

        def check():
            ref = gi.DfsRecordSource(list(c.masters), paths, RECORD)
            src = rs.DfsRecordSource(_factory(c), paths, RECORD)
            try:
                per = len(src)
                assert per == 64 and per % BATCH == 0
                want = _batches(gi.make_dataset(ref, batch_size=BATCH,
                                                shuffle_seed=9, num_epochs=3))
                got = _batches(rs.make_dataset(src, batch_size=BATCH,
                                               shuffle_seed=9, num_epochs=3,
                                               device=CPU))
                assert len(got) == len(want) == 3 * per // BATCH
                assert _epoch_counters(got, per) == \
                    _epoch_counters(want, per) == \
                    [Counter(_records(files))] * 3
            finally:
                ref.close()
                src.close()

        await asyncio.to_thread(check)
    finally:
        await c.stop()


def test_epoch_sampler_shards_by_process_group(monkeypatch):
    """With a process group, rank r of w reads records r::w (the
    reference's ``ds[process_index::process_count]``), then shuffles within
    that shard; forever when ``num_epochs=None``."""
    import torch.distributed as dist

    s = rs.EpochSampler(10, rank=1, world=3)
    assert list(s) == [1, 4, 7]
    shuffled = rs.EpochSampler(10, rank=1, world=3, seed=0, num_epochs=2)
    out = list(shuffled)
    assert sorted(out[:3]) == sorted(out[3:]) == [1, 4, 7]
    forever = iter(rs.EpochSampler(4, num_epochs=None))
    assert [next(forever) for _ in range(10)] == [0, 1, 2, 3] * 2 + [0, 1]
    assert list(rs.EpochSampler(0, num_epochs=None)) == []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert rs._process_shard() == (1, 2)

    class Five:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return np.full(2, i, dtype=np.int64)

    got = [b.tolist() for b in rs.make_dataset(Five(), batch_size=2,
                                                num_epochs=2, device=CPU)]
    assert got == [[[1, 1], [3, 3]], [[1, 1], [3, 3]]]
    got = list(rs.make_dataset(Five(), batch_size=5, device=CPU,
                               shard_by_process=False))
    assert [b[:, 0].tolist() for b in got] == [[0, 1, 2, 3, 4]]


def test_device_iterator_lands_and_splits():
    batches = [torch.arange(12).reshape(4, 3) + 100 * i for i in range(3)]
    out = list(rs.device_iterator(batches, CPU))
    assert all(torch.equal(a, b) for a, b in zip(out, batches))
    split = list(rs.device_iterator(batches, [CPU, CPU]))
    for parts, whole in zip(split, batches):
        assert [p.shape for p in parts] == [(2, 3), (2, 3)]
        assert torch.equal(torch.cat(parts), whole)
    with pytest.raises(ValueError, match="evenly"):
        list(rs.device_iterator(batches, [CPU, CPU, CPU]))
    with pytest.raises(ValueError, match="at least one"):
        rs.device_iterator(batches, [])


# ---------------------------------------------- training loops on the port

FEATURES = 8
RECORD_FLOATS = FEATURES + 1


def _shard(seed: int, w_true: np.ndarray, n: int = 96) -> bytes:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, FEATURES)).astype(np.float32)
    y = (x @ w_true).astype(np.float32)
    return np.concatenate([x, y[:, None]], axis=1).tobytes()


async def test_torch_dataset_dataloader_trains_from_dfs(tmp_path):
    """``tests/test_torch_interop.py``'s first loop on the port's
    ``DfsTorchDataset``, with the same records as the reference's."""
    from tpudfs.tpu.torch_data import DfsTorchDataset as RefDataset

    w_true = np.random.default_rng(5).normal(size=FEATURES).astype(np.float32)
    files = [(f"/torch/shard-{i}.f32", _shard(10 + i, w_true))
             for i in range(3)]
    c, client = await _cluster(tmp_path, files)
    try:
        paths = [f[0] for f in files]

        def train():
            ds = DfsTorchDataset(_factory(c), paths, RECORD_FLOATS * 4,
                                 dtype="float32")
            ref = RefDataset(list(c.masters), paths, RECORD_FLOATS * 4,
                             dtype="float32")
            try:
                assert len(ds) == len(ref) == 3 * 96
                for i in (0, 95, 96, 287):
                    assert torch.equal(ds[i], ref[i])
                assert ds[0].shape == (RECORD_FLOATS,)
                loader = torch.utils.data.DataLoader(
                    ds, batch_size=32, shuffle=True,
                    generator=torch.Generator().manual_seed(0))
                w = torch.zeros(FEATURES, requires_grad=True)
                opt = torch.optim.SGD([w], lr=0.1)
                losses = []
                for _epoch in range(6):
                    for batch in loader:
                        x, y = batch[:, :FEATURES], batch[:, FEATURES]
                        loss = ((x @ w - y) ** 2).mean()
                        opt.zero_grad()
                        loss.backward()
                        opt.step()
                        losses.append(loss.detach().item())
                return w.detach().numpy(), losses
            finally:
                ds.close()
                ref.close()

        w, losses = await asyncio.to_thread(train)
        assert losses[-1] < losses[0] / 10, (losses[0], losses[-1])
        assert np.linalg.norm(w - w_true) < 0.5 * np.linalg.norm(w_true)
    finally:
        await c.stop()


async def test_torch_dataset_multiworker_spawn_bit_exact(tmp_path):
    """``num_workers=2`` with spawn: each worker rebuilds its client from
    the pickled factory; rows arrive bit-exact and in order."""
    w_true = np.random.default_rng(6).normal(size=FEATURES).astype(np.float32)
    files = [(f"/torchw/shard-{i}.f32", _shard(20 + i, w_true, n=64))
             for i in range(2)]
    c, client = await _cluster(tmp_path, files)
    try:
        paths = [f[0] for f in files]

        def load_all():
            ds = DfsTorchDataset(_factory(c), paths, RECORD_FLOATS * 4,
                                 dtype="float32")
            try:
                loader = torch.utils.data.DataLoader(
                    ds, batch_size=16, num_workers=2,
                    multiprocessing_context="spawn")
                return torch.cat(list(loader)).numpy()
            finally:
                ds.close()

        got = await asyncio.to_thread(load_all)
        want = np.concatenate([np.frombuffer(d, dtype=np.float32)
                               .reshape(-1, RECORD_FLOATS) for _p, d in files])
        np.testing.assert_array_equal(got, want)
    finally:
        await c.stop()


E2E_FEATURES = 16
E2E_RECORDS = 128
E2E_BATCH = 64


def _e2e_shard(seed: int, w_true: np.ndarray) -> bytes:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E2E_RECORDS, E2E_FEATURES)).astype(np.float32)
    y = (x @ w_true + 0.01 * rng.normal(size=E2E_RECORDS)).astype(np.float32)
    return np.concatenate([x, y[:, None]], axis=1).tobytes()


def _epochs(factory, paths, w0, n_epochs, seed):
    """Torch SGD over the port's pipeline; each batch split across two
    devices (the data-parallel layout) and the step taken on the whole."""
    record = (E2E_FEATURES + 1) * 4
    source = rs.DfsRecordSource(factory, paths, record, dtype="float32")
    try:
        ds = rs.make_dataset(source, batch_size=E2E_BATCH, shuffle_seed=seed,
                             num_epochs=n_epochs, device=CPU)
        w = torch.tensor(w0, requires_grad=True)
        opt = torch.optim.SGD([w], lr=0.1)
        losses = []
        for parts in rs.device_iterator(ds, [CPU, CPU]):
            assert [p.shape for p in parts] == \
                [(E2E_BATCH // 2, E2E_FEATURES + 1)] * 2
            batch = torch.cat(parts)
            x, y = batch[:, :E2E_FEATURES], batch[:, E2E_FEATURES]
            loss = ((x @ w - y) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        return w.detach().numpy(), losses
    finally:
        source.close()


async def test_sgd_on_dfs_batches_learns(tmp_path):
    """``tests/test_train_e2e.py``'s first loop on the port."""
    w_true = np.random.default_rng(99).normal(size=E2E_FEATURES).astype(
        np.float32)
    files = [(f"/train/shard-{i:02d}.f32", _e2e_shard(7 + i, w_true))
             for i in range(4)]
    c, client = await _cluster(tmp_path, files, block_size=2048)
    try:
        w, losses = await asyncio.to_thread(
            _epochs, _factory(c, 2048), [f[0] for f in files],
            np.zeros(E2E_FEATURES, np.float32), 4, 3)
        assert len(losses) == 4 * (4 * E2E_RECORDS // E2E_BATCH)
        assert losses[-1] < losses[0] / 10, (losses[0], losses[-1])
        assert np.linalg.norm(w - w_true) < 0.5 * np.linalg.norm(w_true)
    finally:
        await c.stop()


async def test_training_checkpoints_through_port_manager_and_resumes(tmp_path):
    """``tests/test_train_e2e.py``'s checkpoint-and-resume loop on the
    port: train, save the model state through the port's
    ``CheckpointManager`` (hot copy + RS(2,1) cold copy), restore it into
    device memory with a fresh manager, resume, and keep improving."""
    w_true = np.random.default_rng(41).normal(size=E2E_FEATURES).astype(
        np.float32)
    files = [(f"/ckpt/shard-{i:02d}.f32", _e2e_shard(50 + i, w_true))
             for i in range(4)]
    c, client = await _cluster(tmp_path, files, block_size=2048)
    try:
        paths = [f[0] for f in files]
        w1, losses1 = await asyncio.to_thread(
            _epochs, _factory(c, 2048), paths,
            np.zeros(E2E_FEATURES, np.float32), 2, 3)
        mgr = CheckpointManager(client, "/ckpt/model", num_shards=1,
                                ec=(2, 1), scopes=resilience)
        await mgr.save(1, {0: {"w": w1, "step": np.int64(len(losses1))}})
        fresh = Client(list(c.masters), rpc_client=c.client, block_size=2048)
        restored = await CheckpointManager(
            fresh, "/ckpt/model", num_shards=1, ec=(2, 1),
            reader=HbmReader(fresh, [CPU])).restore(device=CPU)
        w_back = restored[0]["w"]
        assert w_back.dtype == torch.float32 and w_back.device == CPU
        np.testing.assert_array_equal(w_back.numpy(), w1)
        assert int(restored[0]["step"]) == len(losses1)
        w2, losses2 = await asyncio.to_thread(
            _epochs, _factory(c, 2048), paths, w_back.numpy(), 2, 7)
        assert losses2[-1] < losses1[-1] / 2, (losses1[-1], losses2[-1])
        assert np.linalg.norm(w2 - w_true) < np.linalg.norm(w1 - w_true)
    finally:
        await c.stop()


async def test_training_survives_chunkserver_failure(tmp_path):
    """``tests/test_train_e2e.py``'s failover loop on the port, with its
    constants: a chunkserver stops after step 3, the infeed's byte-range
    reads fail over to the surviving replicas (the test session turns the
    local short circuit off, so every read goes to a chunkserver), and the
    loop still learns."""
    w_true = np.random.default_rng(43).normal(size=E2E_FEATURES).astype(
        np.float32)
    files = [(f"/ft/shard-{i:02d}.f32", _e2e_shard(70 + i, w_true))
             for i in range(4)]
    c, client = await _cluster(tmp_path, files, block_size=2048)
    try:
        paths = [f[0] for f in files]
        killed = asyncio.Event()
        loop = asyncio.get_running_loop()

        def run():
            source = rs.DfsRecordSource(_factory(c, 2048), paths,
                                        (E2E_FEATURES + 1) * 4,
                                        dtype="float32")
            try:
                ds = rs.make_dataset(source, batch_size=E2E_BATCH,
                                     shuffle_seed=5, num_epochs=4, device=CPU)
                w = torch.zeros(E2E_FEATURES, requires_grad=True)
                opt = torch.optim.SGD([w], lr=0.1)
                losses = []
                for step, batch in enumerate(rs.device_iterator(ds, CPU)):
                    if step == 3:
                        # Worker thread -> loop: a thread-safe signal only.
                        loop.call_soon_threadsafe(killed.set)
                    x, y = batch[:, :E2E_FEATURES], batch[:, E2E_FEATURES]
                    loss = ((x @ w - y) ** 2).mean()
                    opt.zero_grad()
                    loss.backward()
                    opt.step()
                    losses.append(loss.item())
                return w.detach().numpy(), losses
            finally:
                source.close()

        async def killer():
            await killed.wait()
            await c.chunkservers[0].stop()
            c.heartbeats[0].stop()

        (w, losses), _ = await asyncio.gather(asyncio.to_thread(run),
                                              killer())
        assert len(losses) == 4 * (4 * E2E_RECORDS // E2E_BATCH)
        assert losses[-1] < losses[0] / 10, (losses[0], losses[-1])
        assert np.linalg.norm(w - w_true) < 0.5 * np.linalg.norm(w_true)
    finally:
        await c.stop()
