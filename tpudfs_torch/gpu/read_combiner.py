"""Batched DFS → GPU reads: the read combiner — port of
``tpudfs/tpu/read_combiner.py``.

Concurrent per-block readers STAGE block requests, and a two-stage drain
pipeline fuses each round into

1. ONE native multi-block pread into one pooled host buffer
   (``tpudfs_blocks_read``, ``native/blockio.cc``; the GIL is released for
   the whole round),
2. ONE host→device copy of that buffer, and
3. ONE launch of the fused whole-block CRC kernel
   (``batch_block_crc_device``) whose (n,) result is compared on the host
   by the reader's one-copy ``confirm``.

The two stages are separate tasks joined by a small queue, so round
``i+1``'s preads overlap round ``i``'s copy. Rounds form from whatever
accumulated while the previous round was in flight. Round sizes are powers
of two (at most ``max_batch``), as in the reference, so a round's shape is
one of a handful.

On a CUDA device the pool's buffers are pinned host memory: the copy is a
real DMA that runs while the host reads the next round, and a buffer goes
back to the pool only after an event recorded behind its copies has
completed. On the CPU device ``.to("cpu")`` would return the buffer itself,
so each round's words are cloned before the buffer is reused.

Blocks that do not fit the fused path (EC-striped, unchecksummed, not
chunk-aligned, no colocated replica and no remote transport, or a
short/failed pread) fall back to the caller's general per-block path, which
handles degraded EC reads and corruption retry.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from tpudfs_torch.client.local import is_error_named
from tpudfs_torch.common import native, trace
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c
from tpudfs_torch.gpu import (
    device_constant,
    resolve_device,
    reused_to_device,
    wait_events,
)
from tpudfs_torch.gpu.crc32c_cuda import (
    WORDS_PER_CHUNK,
    batch_block_crc_device,
    fold_ops,
    word_contrib_table,
)

logger = logging.getLogger(__name__)

#: Largest fused round, in blocks.
DEFAULT_MAX_BATCH = 32
#: Byte budget for one REMOTE round: under both transports' 100 MiB
#: frame/message caps including framing; oversized blocks round down to 1.
REMOTE_ROUND_BYTES = 48 << 20


@dataclass
class DeviceBatch:
    """One fused round on the device: ``words`` holds ``nblocks``
    consecutive blocks of ``cpb`` chunks each; ``crcs`` is the (nblocks,)
    on-device whole-block CRC vector (None when the round was verified on
    the host), resolved by the reader's ``confirm`` into ``resolved``."""

    words: torch.Tensor  # (nblocks * cpb, 128) uint32, on the device
    crcs: torch.Tensor | None  # (nblocks,) uint32, on the device
    cpb: int
    nblocks: int
    resolved: np.ndarray | None = None

    def block_words(self, i: int) -> torch.Tensor:
        return self.words[i * self.cpb : (i + 1) * self.cpb]


@dataclass
class _Req:
    block: dict
    path: str  # local store path ("" for remote rounds)
    cpb: int
    size: int
    addr: str | None = None  # remote origin chunkserver (None = local)
    fut: asyncio.Future = field(default=None)  # created on the running loop


_FALLBACK = object()  # resolve-to-slow-path sentinel


def _bucket(n: int, cap: int) -> int:
    """Largest power of two ≤ min(n, cap): the round size actually taken."""
    n = min(n, cap)
    return 1 << (n.bit_length() - 1)


class ReadCombiner:
    def __init__(self, client, device=None, *,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 host_verify: bool | None = None):
        self.client = client
        self.device = resolve_device(device)
        self.max_batch = max_batch
        #: Where the whole-block CRC runs. On a card the fused kernel
        #: computes it (one launch a round, verdicts settled at confirm);
        #: on the CPU device the plain twin would be the slow part, so the
        #: CRC is taken inside the native pread (tpudfs_blocks_read_crc)
        #: and blocks arrive verified.
        if host_verify is None:
            host_verify = self.device.type != "cuda"
        self.host_verify = host_verify
        self._pending: list[_Req] = []
        self._read_task: asyncio.Task | None = None
        self._upload_task: asyncio.Task | None = None
        self._queue: asyncio.Queue | None = None
        #: Reusable round buffers keyed by row count: pinned on a card, so
        #: the copy is a DMA and the pages stay mapped across rounds.
        self._buf_pool: dict[int, list[torch.Tensor]] = {}
        #: rounds fused / blocks served (observability + tests).
        self.rounds = 0
        self.blocks = 0
        #: Wall seconds per stage, summed over rounds: new round buffers
        #: (``alloc``), the native pread (``pread``, worker thread), the
        #: copy + CRC enqueue (``upload``, worker thread) and the waits for
        #: copies to complete before a buffer is pooled again
        #: (``copy_wait``), failed rounds included: the spans
        #: ``combiner.<key>``. The stages overlap; the sums are not additive.
        self.stage_s = dict.fromkeys(("alloc", "pread", "upload",
                                      "copy_wait"), 0.0)

    def _alloc_round_buf(self, nrows: int) -> torch.Tensor:
        """One round's pread target: a (nrows, 128) uint32 view of a host
        buffer, pinned when the combiner's device is a card."""
        raw = torch.empty(nrows * CHECKSUM_CHUNK_SIZE, dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        return raw.view(torch.uint32).view(nrows, WORDS_PER_CHUNK)

    _POOL_PER_SHAPE = 3

    def _get_buf(self, nrows: int) -> torch.Tensor:
        free = self._buf_pool.get(nrows)
        if free:
            return free.pop()
        with trace.span("combiner.alloc", stages=self.stage_s):
            return self._alloc_round_buf(nrows)

    def _put_buf(self, buf: torch.Tensor | None) -> None:
        if buf is None:
            return
        free = self._buf_pool.setdefault(buf.shape[0], [])
        if len(free) < self._POOL_PER_SHAPE:
            free.append(buf)

    # ------------------------------------------------------------- staging

    async def read(self, block: dict) -> tuple[DeviceBatch, int] | None:
        """Stage one block; returns the :class:`DeviceBatch` of the round
        it rode and its index there (lazily verified on a card), or None
        when the block must take the general path."""
        size = int(block.get("size") or 0)
        if (
            block.get("ec_data_shards")
            or not block.get("checksum_crc32c")
            or size <= 0
            or size % CHECKSUM_CHUNK_SIZE != 0
        ):
            return None
        store = None
        if self.client.local_reads:
            for addr in block.get("locations") or []:
                if not addr:
                    continue
                s = await self.client._local_store(addr)
                if s is not None:
                    store = s
                    break
        path, remote = "", None
        if store is not None:
            try:
                path = str(store.block_path(block["block_id"]))
            except ValueError:
                return None
        else:
            # No colocated replica: fuse over the wire when the client has
            # a transport (one ReadBlocks frame per round and origin).
            remote = next((a for a in block.get("locations") or [] if a),
                          None)
            if remote is None or not hasattr(self.client, "_data_call"):
                return None
        req = _Req(block=block, path=path,
                   cpb=size // CHECKSUM_CHUNK_SIZE, size=size, addr=remote,
                   fut=asyncio.get_running_loop().create_future())
        # Mark retrieved even when the awaiting reader is cancelled away.
        req.fut.add_done_callback(
            lambda f: None if f.cancelled() else f.exception()
        )
        self._pending.append(req)
        self._ensure_running()
        result = await asyncio.shield(req.fut)
        if result is _FALLBACK:
            return None
        return result

    def _ensure_running(self) -> None:
        if self._read_task is None or self._read_task.done():
            self._queue = asyncio.Queue(maxsize=2)
            self._read_task = asyncio.create_task(self._read_stage())
            self._upload_task = asyncio.create_task(
                self._upload_stage(self._queue)
            )

    # ------------------------------------------------------- stage 1: disk

    async def _read_stage(self) -> None:
        queue = self._queue
        aborted = True
        try:
            while self._pending:
                # One round: the leading request's (chunk count, origin)
                # picks the group. Mixed requests only split rounds.
                cpb = self._pending[0].cpb
                origin = self._pending[0].addr
                uniform = [r for r in self._pending
                           if r.cpb == cpb and r.addr == origin]
                cap = self.max_batch
                if origin is not None:
                    stride = cpb * CHECKSUM_CHUNK_SIZE
                    cap = min(cap, max(1, REMOTE_ROUND_BYTES // stride))
                take = _bucket(len(uniform), cap)
                reqs = uniform[:take]
                taken = set(map(id, reqs))
                self._pending = [
                    r for r in self._pending if id(r) not in taken
                ]
                buf = self._get_buf(len(reqs) * cpb)
                try:
                    async with trace.span("combiner.pread",
                                          stages=self.stage_s):
                        if origin is not None:
                            ok, crcs = await self._fetch_remote(reqs, buf)
                        else:
                            ok, crcs = await asyncio.to_thread(
                                self._fill_buffer, reqs, buf
                            )
                except asyncio.CancelledError:
                    self._put_buf(buf)
                    self._fail_out(reqs)
                    raise
                except Exception as e:
                    # One bad round must not kill the stage: route its
                    # blocks to the per-block path and keep draining.
                    logger.warning("fused read round failed (%s); "
                                   "falling back %d blocks", e, len(reqs))
                    self._put_buf(buf)
                    for r in reqs:
                        if not r.fut.done():
                            r.fut.set_result(_FALLBACK)
                    continue
                if crcs is not None:
                    # Host-verified round: a mismatch is a corrupt replica;
                    # the general path's verified retry excludes it.
                    for i, r in enumerate(reqs):
                        if ok[i] and int(crcs[i]) != int(
                                r.block["checksum_crc32c"]):
                            logger.warning(
                                "fused read: CRC mismatch on replica of %s; "
                                "falling back", r.block["block_id"])
                            ok[i] = False
                good = [r for r, o in zip(reqs, ok) if o]
                for r, o in zip(reqs, ok):
                    if not o and not r.fut.done():
                        r.fut.set_result(_FALLBACK)
                if not good:
                    self._put_buf(buf)
                    continue
                # Compact the good slots to the front of the buffer in
                # request order (row block i belongs to good[i]). Slot j
                # moves to i < j, so no slot is overwritten before it is
                # read, and the buffer stays pooled (and pinned).
                dst = 0
                for i, o in enumerate(ok):
                    if o:
                        if i != dst:
                            buf[dst * cpb : (dst + 1) * cpb].copy_(
                                buf[i * cpb : (i + 1) * cpb])
                        dst += 1
                # Ship in power-of-two sub-rounds (a full round in one);
                # the LAST sub-round carries the buffer as its release
                # token: the upload stage pools it once every sub-round's
                # copy has completed.
                off = 0
                while off < len(good):
                    take = 1 << ((len(good) - off).bit_length() - 1)
                    last = off + take >= len(good)
                    await queue.put((
                        good[off : off + take],
                        buf[off * cpb : (off + take) * cpb],
                        cpb, crcs is not None,
                        buf if last else None,
                    ))
                    off += take
            aborted = False
        finally:
            # Clear the task slot (no await since the empty-pending check)
            # BEFORE the suspending sentinel put, so a request staged while
            # we drain out restarts the stages. On cancellation the still
            # pending requests are ours and would otherwise wait forever.
            self._read_task = None
            if aborted:
                self._fail_out(self._pending)
                self._pending = []
            await queue.put(None)

    def _fail_out(self, reqs: list[_Req]) -> None:
        for r in reqs:
            if not r.fut.done():
                r.fut.set_exception(
                    RuntimeError("read combiner shut down mid-request")
                )

    async def _fetch_remote(
        self, reqs: list[_Req], buf: torch.Tensor,
    ) -> tuple[list[bool], np.ndarray | None]:
        """One ReadBlocks frame to the round's origin chunkserver. Slots the
        peer could not serve fall back to the per-block path; in
        host-verify mode the received bytes are re-checked against the
        recorded whole-block CRCs. ``buf`` is the pooled round buffer; the
        payload lands in it through numpy views of its bytes."""
        addr = reqs[0].addr
        cpb = reqs[0].cpb
        stride = cpb * CHECKSUM_CHUNK_SIZE
        flat = buf.view(torch.uint8).reshape(-1).numpy()
        scatter_ok: list[bool] | None = None

        def scatter(header: dict, plen: int):
            """Blockport scatter: each slot's payload span straight into
            its round-buffer position. Mismatched/short slots drain into
            scratch so the stream stays framed. None (-> bytes fallback)
            when the header does not look like a success with sizes."""
            nonlocal scatter_ok
            if not header.get("ok") or "sizes" not in header:
                return None
            sizes = list(header.get("sizes") or [])
            if len(sizes) != len(reqs):
                return None
            segs = []
            oks = []
            covered = 0
            for i, r in enumerate(reqs):
                sz = sizes[i]
                if sz is None or sz < 0:
                    oks.append(False)
                    continue
                covered += sz
                if covered > plen:
                    # Untrusted header sizes: never allocate past the
                    # framed payload.
                    return None
                if sz == r.size:
                    segs.append(flat[i * stride : i * stride + sz])
                    oks.append(True)
                else:
                    segs.append(np.empty(sz, dtype=np.uint8))  # drain
                    oks.append(False)
            if covered != plen:
                return None
            scatter_ok = oks
            return segs

        try:
            resp = await self.client._data_call(
                addr, "ReadBlocks",
                {"block_ids": [r.block["block_id"] for r in reqs]},
                timeout=60.0, payload_into=scatter,
            )
        except Exception as e:
            if not is_error_named(e, "RpcError"):
                raise
            logger.debug("remote fused round to %s failed: %s", addr, e)
            return [False] * len(reqs), None
        if scatter_ok is not None:
            ok = scatter_ok
        else:
            # gRPC path (or fallback): the payload arrives as one bytes.
            sizes = list(resp.get("sizes") or [])
            data = resp.get("data") or b""
            ok = []
            pos = 0
            for i, r in enumerate(reqs):
                sz = sizes[i] if i < len(sizes) else -1
                if sz is None or sz < 0:
                    ok.append(False)
                    continue
                end = pos + sz
                span = np.frombuffer(data, dtype=np.uint8,
                                     count=sz, offset=pos) \
                    if end <= len(data) else None
                pos = end
                if sz != r.size or span is None:
                    ok.append(False)
                    continue
                flat[i * stride : i * stride + sz] = span
                ok.append(True)
        if not self.host_verify:
            return ok, None
        crcs = await asyncio.to_thread(self._host_crcs, reqs, flat, ok)
        return ok, crcs

    def _host_crcs(self, reqs: list[_Req], flat: np.ndarray,
                   ok: list[bool]) -> np.ndarray:
        stride = reqs[0].cpb * CHECKSUM_CHUNK_SIZE
        out = np.zeros(len(reqs), dtype=np.uint32)
        for i, r in enumerate(reqs):
            if ok[i]:
                out[i] = crc32c(flat[i * stride : i * stride + r.size])
        return out

    def _fill_buffer(
        self, reqs: list[_Req], buf: torch.Tensor,
    ) -> tuple[list[bool], np.ndarray | None]:
        """Worker thread: one native call preads every request's file into
        the pooled round buffer (by its data pointer); in ``host_verify``
        mode it also returns each slot's whole-block CRC."""
        stride = reqs[0].cpb * CHECKSUM_CHUNK_SIZE
        sizes, crcs = native.blocks_read(
            [r.path for r in reqs], stride, buf.data_ptr(),
            with_crc=self.host_verify)
        return [int(s) == r.size for s, r in zip(sizes, reqs)], crcs

    # ----------------------------------------------------- stage 2: device

    def _upload(self, rows: torch.Tensor, nblocks: int,
                host_verified: bool):
        """Worker thread: one copy of the round's rows to the device and,
        unless verified on the host, one fused CRC launch behind it on the
        same stream. Returns (words, crcs, copy-done event or None)."""
        words, done = reused_to_device(rows.view(torch.int32), self.device)
        words = words.view(torch.uint32)
        crcs = None if host_verified else \
            batch_block_crc_device(words, nblocks)
        return words, crcs, done

    async def _upload_stage(self, queue: asyncio.Queue) -> None:
        #: copy-done events of the sub-rounds sharing the current
        #: (unreleased) buffer: a non-blocking copy has only been enqueued
        #: when .to() returns, so the buffer returns to the pool only once
        #: every one of them has completed.
        since_release: list = []
        skip_next_release = False  # a sub-round of this buffer failed
        while True:
            item = await queue.get()
            if item is None:
                return
            reqs, rows, cpb, host_verified, release = item
            try:
                async with trace.span("combiner.upload",
                                      stages=self.stage_s):
                    words, crcs, done = await asyncio.to_thread(
                        self._upload, rows, len(reqs), host_verified)
                if release is not None and not skip_next_release:
                    async with trace.span("combiner.copy_wait",
                                          stages=self.stage_s):
                        await asyncio.to_thread(wait_events,
                                                since_release + [done])
            except asyncio.CancelledError:
                self._fail_out(reqs)
                raise
            except Exception as e:
                # A failed upload must not kill the consumer (the producer
                # would block on the full queue): fall this round back to
                # the per-block path and keep consuming.
                logger.warning("fused upload failed (%s); falling back "
                               "%d blocks", e, len(reqs))
                since_release = []  # buffer state unknown: drop, don't pool
                skip_next_release = release is None
                for r in reqs:
                    if not r.fut.done():
                        r.fut.set_result(_FALLBACK)
                continue
            if release is not None:
                if skip_next_release:
                    skip_next_release = False  # buffer dropped, not pooled
                else:
                    self._put_buf(release)
                since_release = []
            else:
                since_release.append(done)
            batch = DeviceBatch(words=words, crcs=crcs, cpb=cpb,
                                nblocks=len(reqs))
            self.rounds += 1
            self.blocks += len(reqs)
            for i, r in enumerate(reqs):
                if not r.fut.done():
                    r.fut.set_result((batch, i))

    # -------------------------------------------------------------- warmup

    def warm(self, cpb: int) -> None:
        """Take first-use costs out of the first timed round: allocate one
        pooled (pinned, on a card) buffer for every round size and, where
        the card verifies, load the CRC kernel library and upload its
        constant tables. Nothing is launched."""
        b = 1
        while b <= self.max_batch:
            free = self._buf_pool.setdefault(b * cpb, [])
            if not free:
                free.append(self._alloc_round_buf(b * cpb))
            b <<= 1
        if self.host_verify or self.device.type != "cuda":
            return
        from tpudfs_torch.gpu import kernels

        kernels.lib("crc32c")
        device_constant("word_contrib_table", self.device, word_contrib_table)
        device_constant("crc32c_fold_ops", self.device, fold_ops)
