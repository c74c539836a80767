"""Training infeed: stream DFS files straight into device memory — port of
``tpudfs/tpu/infeed.py``.

An async prefetcher pulls files from the DFS through :class:`HbmReader`
(per-block device placement, verified on the device) while the consumer,
typically a training step, works on the previous file. A synchronous
iterator bridges into ordinary training loops by running the asyncio
machinery on a background thread.

Spans: ``infeed.file`` (the producer reading one file), ``infeed.put_wait``
(the producer blocked on a full queue), ``infeed.get_wait`` (the
synchronous consumer blocked on an empty one).
"""

from __future__ import annotations

import asyncio
import queue
import threading
from collections.abc import Iterator, Sequence

import torch

from tpudfs_torch.common import trace
from tpudfs_torch.gpu.hbm_reader import DeviceBlock, HbmReader


class DfsInfeed:
    """Async prefetching iterator over DFS files → per-block device tensors.
    ``devices`` defaults to ``cuda:0`` (raises without a card)."""

    def __init__(self, client, paths: Sequence[str],
                 devices: list | None = None, prefetch: int = 2,
                 verify: bool = True):
        self.reader = HbmReader(client, devices)
        self.paths = list(paths)
        self.prefetch = prefetch
        self.verify = verify

    async def __aiter__(self):
        pending: asyncio.Queue = asyncio.Queue(self.prefetch)

        async def producer():
            try:
                for path in self.paths:
                    async with trace.span("infeed.file") as sp:
                        blocks = await self.reader.read_file_to_device_blocks(
                            path, verify=self.verify
                        )
                        sp.nbytes = sum(b.size for b in blocks)
                    async with trace.span("infeed.put_wait"):
                        await pending.put((path, blocks))
                await pending.put(None)
            except asyncio.CancelledError:
                # Consumer gone (early exit cancelled us): nobody drains the
                # queue, so a blocking put would pin this task and its
                # prefetched device blocks forever. Just unwind.
                raise
            except BaseException as e:
                # A failed prefetch must surface to the consumer, not hang it.
                await pending.put(e)
                raise

        task = asyncio.create_task(producer())
        try:
            while True:
                item = await pending.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            task.cancel()

    def as_sync_iterator(self) -> Iterator[tuple[str, list[DeviceBlock]]]:
        """Run the async prefetcher on a daemon thread; yield synchronously.
        Early exit (break) stops the producer thread and releases the
        prefetched device blocks."""
        out: queue.Queue = queue.Queue(self.prefetch)
        stop = threading.Event()
        _SENTINEL = object()

        def runner():
            async def pump():
                async for item in self.__aiter__():
                    # Bounded put with a stop check, so an abandoned
                    # consumer does not pin this thread (and its blocks).
                    with trace.span("infeed.put_wait"):
                        while not stop.is_set():
                            try:
                                out.put(item, timeout=0.25)
                                break
                            except queue.Full:
                                continue
                    if stop.is_set():
                        return

            try:
                asyncio.run(pump())
                out.put(_SENTINEL)
            except BaseException as e:  # surface errors to the consumer
                if not stop.is_set():
                    out.put(e)

        threading.Thread(target=runner, daemon=True).start()
        try:
            while True:
                with trace.span("infeed.get_wait"):
                    item = out.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not out.empty():
                try:
                    out.get_nowait()
                except queue.Empty:
                    break


def batch_words(blocks: list[DeviceBlock]) -> torch.Tensor:
    """Stack equally sized device blocks into a (B, chunks, 128) uint32
    batch (blocks must live on one device). Stacked as int32: a same-size
    view, since uint32 has few torch ops."""
    return torch.stack([b.array.view(torch.int32) for b in blocks]) \
        .view(torch.uint32)
