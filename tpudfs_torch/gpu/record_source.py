"""Fixed-size records in DFS files as a PyTorch training pipeline — port of
``tpudfs/tpu/grain_infeed.py``.

- :class:`DfsRecordSource` — a map-style source of fixed-size records
  carved out of DFS files, fetched by byte range through a DFS client
  (``read_meta_range`` against cached file metadata: no metadata
  round-trip per record). ``DataLoader`` workers call ``__getitem__``; the
  asyncio client runs on a dedicated event-loop thread per process.
- :func:`make_dataset` — source → shard by ``torch.distributed`` rank →
  shuffle per epoch → repeat → batch, on a ``torch.utils.data.DataLoader``
  (pinned batches when the target is a card).
- :func:`device_iterator` — lands every batch on the card (or splits its
  first dimension across several devices, the data-parallel layout).

Deliberate difference from the reference: the reference builds a
``tpudfs.client.Client`` from ``master_addrs`` inside each process; the
port takes ``client_factory``, a picklable zero-argument callable that the
source calls inside its own event-loop thread (for example
``functools.partial(Client, master_addrs, tenant=...)``, or
``functools.partial(LocalClient, stores, metas)`` on a host whose
chunkservers are colocated). Errors of the client are matched by class
name.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import os
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from tpudfs_torch.client.local import is_error_named
from tpudfs_torch.gpu import resolve_device

logger = logging.getLogger(__name__)


class _AdaptiveGate:
    """A semaphore whose limit can shrink/grow at runtime (threading
    semaphores can't resize). Fetching workers block here, so lowering the
    limit IS lowering the effective prefetch depth."""

    def __init__(self, limit: int):
        self._cond = threading.Condition()
        self._limit = limit
        self._active = 0

    def set_limit(self, n: int) -> None:
        with self._cond:
            self._limit = max(1, n)
            self._cond.notify_all()

    def __enter__(self):
        with self._cond:
            while self._active >= self._limit:
                self._cond.wait()
            self._active += 1
        return self

    def __exit__(self, *exc):
        with self._cond:
            self._active -= 1
            self._cond.notify_all()


class _OverloadGovernor:
    """Degradation ladder for shed fetches (the cluster said
    RESOURCE_EXHAUSTED and the client's own retries ran out): level 1 drops
    read hedges, each further level halves fetch concurrency down to 1;
    ``RECOVERY_SUCCESSES`` consecutive clean fetches climb one level back
    up. A client without ``hedge_delay`` only has its concurrency cut."""

    RECOVERY_SUCCESSES = 32
    MAX_LEVEL = 5  # 1 hedge drop + concurrency 16 -> 8 -> 4 -> 2 -> 1

    def __init__(self, max_concurrency: int = 16):
        self._lock = threading.Lock()
        self.max_concurrency = max_concurrency
        self.gate = _AdaptiveGate(max_concurrency)
        self.level = 0
        self._streak = 0
        self._saved_hedge: float | None = None

    def _apply(self, client) -> None:
        # Called under _lock.
        if hasattr(client, "hedge_delay"):
            if self.level >= 1:
                if client.hedge_delay is not None:
                    self._saved_hedge = client.hedge_delay
                    client.hedge_delay = None
            elif self._saved_hedge is not None:
                client.hedge_delay = self._saved_hedge
                self._saved_hedge = None
        self.gate.set_limit(self.max_concurrency >> max(0, self.level - 1))

    def on_overload(self, client) -> float:
        """Step down one level; returns the backoff to sleep before retry."""
        with self._lock:
            self._streak = 0
            if self.level < self.MAX_LEVEL:
                self.level += 1
                self._apply(client)
                logger.warning(
                    "DFS overloaded: infeed degraded to level %d "
                    "(hedges off, concurrency %d)", self.level,
                    self.max_concurrency >> max(0, self.level - 1))
            return min(2.0, 0.1 * (2 ** self.level))

    def on_success(self, client) -> None:
        with self._lock:
            if self.level == 0:
                return
            self._streak += 1
            if self._streak >= self.RECOVERY_SUCCESSES:
                self._streak = 0
                self.level -= 1
                self._apply(client)
                logger.info("DFS recovered: infeed back to level %d",
                            self.level)


class _ClientLoop:
    """A dedicated event-loop thread owning a DFS client, built by
    ``client_factory`` inside that loop (an RPC client's channels bind to
    the loop that created them); sync callers submit coroutines with
    ``run_coroutine_threadsafe``."""

    def __init__(self, client_factory: Callable[[], Any]):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, daemon=True,
            name="tpudfs-torch-client",
        )
        self._thread.start()
        try:
            self.client = self.run(self._make_client(client_factory))
        except BaseException:
            self._shutdown_loop()
            raise

    @staticmethod
    async def _make_client(client_factory: Callable[[], Any]):
        return client_factory()

    def run(self, coro, timeout: float = 120.0) -> Any:
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(timeout)
        except TimeoutError:
            # Don't let the orphaned coroutine keep running after the
            # caller has given up on it.
            fut.cancel()
            raise

    def close(self) -> None:
        close = getattr(self.client, "close", None)
        if close is not None:
            async def _close() -> None:
                out = close()
                if inspect.isawaitable(out):
                    await out

            try:
                self.run(_close(), timeout=10.0)
            except Exception:
                logger.warning("DFS client close failed during infeed "
                               "shutdown", exc_info=True)
        self._shutdown_loop()

    def _shutdown_loop(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5.0)
        if not self._thread.is_alive():
            self._loop.close()


class DfsSourceBase:
    """Shared plumbing for DFS-backed sources: a lazily built per-process
    client and event loop (pickle-safe for ``DataLoader`` worker processes)
    and the file-metadata prefetch. Subclasses implement ``_build_index``,
    ``__len__`` and ``__getitem__``.

    ``_lock`` is a ``threading.Lock``, only ever taken on synchronous
    worker threads, never on the client's event loop. A process forked
    from the one that built the client (a ``DataLoader`` worker under the
    fork start method) builds its own: the loop thread does not survive a
    fork."""

    def __init__(self, client_factory: Callable[[], Any]):
        self.client_factory = client_factory
        self._lock = threading.Lock()
        self._cl: _ClientLoop | None = None
        self._cl_pid = 0
        self._governor = _OverloadGovernor()

    def _client_loop(self) -> _ClientLoop:
        with self._lock:
            if self._cl is None or self._cl_pid != os.getpid():
                self._cl = _ClientLoop(self.client_factory)
                self._cl_pid = os.getpid()
            return self._cl

    _OVERLOAD_RETRIES = 8

    def _governed_run(self, cl: _ClientLoop,
                      coro_factory: Callable[[], Any]) -> Any:
        """Run a fetch under the overload governor: gate concurrency, and on
        a shed fetch (an ``OverloadedError`` of any client) degrade, back
        off and retry — a training job rides out overload."""
        with self._governor.gate:
            for _ in range(self._OVERLOAD_RETRIES):
                try:
                    result = cl.run(coro_factory())
                except Exception as e:
                    if not is_error_named(e, "OverloadedError"):
                        raise
                    backoff = self._governor.on_overload(cl.client)
                    last = e
                    time.sleep(backoff)
                else:
                    self._governor.on_success(cl.client)
                    return result
            raise last

    def _fetch_metas(self, paths: Sequence[str]) -> list[dict]:
        """File metadata for every path, failing on missing files."""
        cl = self._client_loop()

        async def metas(client) -> list[dict]:
            out = await asyncio.gather(
                *(client.get_file_info(p) for p in paths)
            )
            for p, m in zip(paths, out):
                if m is None:
                    raise FileNotFoundError(f"DFS file not found: {p}")
            return out

        return self._governed_run(cl, lambda: metas(cl.client))

    def close(self) -> None:
        with self._lock:
            if self._cl is not None and self._cl_pid == os.getpid():
                self._cl.close()
            self._cl = None

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_cl"] = None
        state["_lock"] = None
        state["_governor"] = None  # holds a Condition; rebuilt per process
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self._governor = _OverloadGovernor()


class DfsRecordSource(DfsSourceBase):
    """Map-style source over fixed-size records in DFS files.

    Each record is ``record_bytes`` consecutive bytes; file tails shorter
    than a record are dropped. ``__getitem__`` returns the record as a
    read-only numpy array of ``dtype``. Pickles for ``DataLoader`` worker
    processes: the client is re-created lazily per process."""

    def __init__(self, client_factory: Callable[[], Any],
                 paths: Sequence[str], record_bytes: int,
                 dtype: str = "uint8"):
        if record_bytes <= 0:
            raise ValueError("record_bytes must be positive")
        itemsize = np.dtype(dtype).itemsize
        if record_bytes % itemsize:
            raise ValueError(
                f"record_bytes={record_bytes} is not a multiple of "
                f"dtype {dtype} itemsize {itemsize}"
            )
        super().__init__(client_factory)
        self.paths = list(paths)
        self.record_bytes = int(record_bytes)
        self.dtype = dtype
        # (path, base_offset) per record, built once from file metadata.
        self._index: list[tuple[str, int]] = []
        # Immutable block layout per path (the read_meta_range fast path).
        self._metas: dict[str, dict] = {}
        try:
            self._build_index()
        except BaseException:
            self.close()
            raise

    def _build_index(self) -> None:
        for path, meta in zip(self.paths, self._fetch_metas(self.paths)):
            self._metas[path] = meta
            for off in range(0, int(meta["size"]) - self.record_bytes + 1,
                             self.record_bytes):
                self._index.append((path, off))

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, record_key: int) -> np.ndarray:
        path, off = self._index[record_key]
        cl = self._client_loop()
        data = self._governed_run(
            cl,
            lambda: cl.client.read_meta_range(
                self._metas[path], off, self.record_bytes
            ),
        )
        return np.frombuffer(data, dtype=self.dtype)

    def __repr__(self) -> str:
        return (
            f"DfsRecordSource(files={len(self.paths)}, "
            f"records={len(self._index)}, record_bytes={self.record_bytes})"
        )


class EpochSampler:
    """Record indices of one process's shard (``rank::world``), repeated
    ``num_epochs`` times (``None``: forever). With ``seed`` each epoch is
    a fresh permutation drawn from one ``torch.Generator`` seeded with it
    (so a second iteration replays the same order); without, file order."""

    def __init__(self, n: int, *, rank: int = 0, world: int = 1,
                 seed: int | None = None, num_epochs: int | None = 1):
        self.indices = torch.arange(rank, n, world)
        self.seed = seed
        self.num_epochs = num_epochs

    def __iter__(self):
        if not len(self.indices):
            return
        gen = None
        if self.seed is not None:
            gen = torch.Generator().manual_seed(self.seed)
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            order = self.indices
            if gen is not None:
                order = order[torch.randperm(len(order), generator=gen)]
            yield from order.tolist()
            epoch += 1


def _stack(records: list) -> torch.Tensor:
    return torch.from_numpy(np.stack(records))


def _process_shard() -> tuple[int, int]:
    """(rank, world size) of an initialised default process group, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_dataset(source, *, batch_size: int, shuffle_seed: int | None = None,
                 shard_by_process: bool = True,
                 num_epochs: int | None = 1, device=None,
                 num_workers: int = 0):
    """The pipeline: source → shard by ``torch.distributed`` rank (when a
    process group is initialised and ``shard_by_process``) → per-epoch
    shuffle (``shuffle_seed``) → repeat ``num_epochs`` times (``None``:
    forever) → batches of ``batch_size`` records, the last partial batch
    dropped. Epochs run back to back, so a batch may span two of them, as
    in the reference's grain pipeline.

    Returns a ``torch.utils.data.DataLoader`` yielding tensors of shape
    ``(batch_size, record_bytes // itemsize)``; its batches are pinned
    when ``device`` (default ``cuda:0``, see ``resolve_device``) is a
    card. ``num_workers`` loader workers are spawned (forking a process
    that runs an event-loop thread, or CUDA, is unsafe)."""
    device = resolve_device(device)
    rank, world = _process_shard() if shard_by_process else (0, 1)
    sampler = EpochSampler(len(source), rank=rank, world=world,
                           seed=shuffle_seed, num_epochs=num_epochs)
    batches = torch.utils.data.BatchSampler(sampler, batch_size,
                                            drop_last=True)
    return torch.utils.data.DataLoader(
        source, batch_sampler=batches, collate_fn=_stack,
        pin_memory=device.type == "cuda", num_workers=num_workers,
        multiprocessing_context="spawn" if num_workers else None)


def device_iterator(dataset, devices=None):
    """Iterate ``dataset``'s batches, landing each on the device with
    ``.to(device, non_blocking=True)``.

    ``devices``: one device, or a list. ``None`` means ``cuda:0`` (and
    raises without a card unless the CPU is named). With several devices
    each batch's first dimension is split evenly across them, in order, and
    the iterator yields the list of parts (the data-parallel layout)."""
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("device_iterator needs at least one device")
    return _land(dataset, devices)


def _land(dataset, devices: list):
    n = len(devices)
    for batch in dataset:
        if n == 1:
            yield batch.to(devices[0], non_blocking=True)
            continue
        if batch.shape[0] % n:
            raise ValueError(
                f"batch of {batch.shape[0]} does not split evenly across "
                f"{n} devices")
        yield [part.to(d, non_blocking=True)
               for part, d in zip(batch.chunk(n), devices)]
