"""DFS → GPU memory reader: blocks land as device tensors, verified on the
device — port of ``tpudfs/tpu/hbm_reader.py``.

Per-block path: each block's bytes go from the fetch buffer (a zero-padded
chunk grid the client reads straight into) to its target device in one
copy. A block lands in a slot of the reader's :class:`SlotPool`, reused
from block to block: pinned on a card, where the copy is enqueued from
the event loop without waiting and the slot is written again only once
an event behind that copy has completed; on the CPU the block's words are
cloned out of it. A replicated block's slot is its chunk grid; an
erasure-coded block's holds k rows, one a shard (``_ec_block_to_device``).
A grid from any other source (a client that returns bytes, a second
attempt at a replicated block) is fresh pageable memory, copied in a
worker. The whole-block CRC32C recorded at CompleteFile is computed on
the device by one launch of the fused kernel (``crc32c.cu``: the
per-512-byte-chunk CRCs and their GF(2) combine-fold), with no host
readback. Under ``verify="lazy"`` every
block's verdict stays on the device until :meth:`HbmReader.confirm`
settles them all with one device→host copy. A degraded erasure-coded
block is rebuilt on the device with kernel 2 (``gf256.cu``). Spans
(``tpudfs_torch.common.trace``): ``reader.block`` around a block,
``reader.grid`` around a replicated block's grid preparation (a slot's
first allocation, the wait for its last copy, the tail's zero-fill),
``reader.verify`` around the check, ``ec.read_shards`` around an
erasure-coded block's shard reads, ``ec.stack`` around its rows'
preparation (the slot made ready, the pads' zero-fill, any row copied in
from returned bytes), ``ec.upload`` around its copy's enqueue and
``ec.decode`` around its rebuild. Counters: ``ec.shard_bytes`` (the shard
bytes read), ``ec.rows_landed`` (shards read straight into their row),
``ec.rows_copied`` (rows copied in from returned bytes),
``ec.blocks_assembled`` (blocks joined from their data shards),
``ec.blocks_rebuilt`` (blocks decoded on the device), ``reader.slot_waits``
and ``reader.slot_allocs`` (:class:`SlotPool`).

Batched paths: with ``batch_reads > 0`` lazily verified blocks go through
the read combiner (``read_combiner.py``: one native pread, one copy from a
pinned buffer and one fused CRC launch per round of up to ``batch_reads``
blocks), and :meth:`HbmReader.sweep_metas_to_device` hands whole file sets
to the native sweep pump (a producer thread filling a pinned ring ahead of
the consumer, verifying on the host).

The client is duck-typed: ``tpudfs_torch.client.local.LocalClient`` (the
colocated short-circuit read) or the reference ``tpudfs.client.Client``.
"""

from __future__ import annotations

import asyncio
import ctypes
import threading

import numpy as np
import torch

from tpudfs_torch.client.local import ChecksumMismatchError, DfsError, is_dfs_error
from tpudfs_torch.common import native, trace
from tpudfs_torch.common.checksum import (
    CHECKSUM_CHUNK_SIZE,
    crc32c,
    crc32c_combine,
    crc32c_combine_chunks,
)
from tpudfs_torch.gpu import (
    host_to_device,
    resolve_device,
    reused_to_device,
    u32_to_numpy,
    wait_events,
)
from tpudfs_torch.gpu.crc32c_cuda import (
    WORDS_PER_CHUNK,
    block_crc_device,
    bytes_to_words,
    crc32c_chunks_device,
)
from tpudfs_torch.gpu.read_combiner import DeviceBatch, ReadCombiner
from tpudfs_torch.gpu.rs_cuda import pad_shard_len, rs_decode_device

#: Host bytes that one device's landing slots (:class:`SlotPool`) may
#: hold: 16 slots of 64 MiB blocks. That is more blocks in flight than the
#: default executor has workers on an 8-core card host (12), so the slots
#: hold back no read a worker could start, for 1 GiB of pinned memory.
SLOT_BUDGET = 1 << 30


def padded_len(nbytes: int) -> int:
    """``nbytes`` rounded up to whole checksum chunks, one at least: the
    length of a block's chunk grid."""
    return max(-(-nbytes // CHECKSUM_CHUNK_SIZE), 1) * CHECKSUM_CHUNK_SIZE


class _Slot:
    """One reused host buffer of ``nbytes`` that a block lands in: ``buf``
    (allocated by its first user: pinned on a card) and ``copied``, the
    event recorded behind the last copy out of it (None: no copy can
    still be reading it). The ``landing`` and ``rows`` calls run where the
    read runs, usually a worker thread."""

    __slots__ = ("nbytes", "buf", "host", "copied")

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.buf = self.host = self.copied = None

    def _ready(self, pinned: bool) -> None:
        """Allocated, and read by no copy."""
        if self.buf is None:
            self.buf = torch.empty(self.nbytes, dtype=torch.uint8,
                                   pin_memory=pinned)
            self.host = self.buf.numpy()
        elif self.copied is not None:
            self.copied.synchronize()
        self.copied = None

    def landing(self, nbytes: int, pinned: bool) -> np.ndarray:
        """The slot's first ``nbytes`` for a replicated block to land in,
        the rest of their last chunk zeroed."""
        self._ready(pinned)
        self.host[nbytes:padded_len(nbytes)] = 0
        return self.host[:nbytes]

    def rows(self, k: int, slen: int, stride: int, nbytes: int,
             pinned: bool) -> np.ndarray:
        """The slot's first ``k * stride`` bytes as (k, stride) rows for an
        erasure-coded block's shards of ``slen`` bytes, each row's pad past
        ``slen`` and the bytes from the rows' end to ``nbytes`` zeroed."""
        self._ready(pinned)
        rows = self.host[:k * stride].reshape(k, stride)
        rows[:, slen:] = 0
        self.host[k * stride:nbytes] = 0
        return rows

    def words(self, nbytes: int) -> torch.Tensor:
        """The chunk grid of the ``nbytes`` landed, as (chunks, 128) int32."""
        return self.buf[:padded_len(nbytes)].view(torch.int32) \
            .view(-1, WORDS_PER_CHUNK)


def _wake(fut: asyncio.Future) -> None:
    if not fut.done():
        fut.set_result(None)


class SlotPool:
    """One device's landing slots for the per-block path, reused by size
    and allocated lazily (counter ``reader.slot_allocs``),
    :data:`SLOT_BUDGET` bytes in all at most (``peak``: the most they have
    held). A slot is taken on an event loop before its block's read,
    waiting there while the pool is at its budget (counter
    ``reader.slot_waits``), and given back once the block is done or
    failed. A slot given back with its copy in flight is written again
    only after that copy's event has completed. The pool is bound to no
    loop: a waiter on any loop is woken from any thread."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.budget = SLOT_BUDGET
        self.held = self.peak = 0  # bytes of every slot, free or taken
        self._free: dict[int, list[_Slot]] = {}
        self._waiters: list[tuple[asyncio.AbstractEventLoop,
                                  asyncio.Future]] = []
        self._lock = threading.Lock()

    def size_of(self, nbytes: int) -> int:
        """The bytes a slot for ``nbytes`` holds: on a card, what PyTorch's
        caching host allocator pins for it, the next power of two."""
        return 1 << max(nbytes - 1, 0).bit_length() if self.pinned \
            else nbytes

    def _take_locked(self, nbytes: int) -> _Slot | None:
        # The smallest free slot that fits, of the size asked for where
        # there is one; a larger one (a tail block's, an EC block's rows)
        # before any slot is evicted.
        fits = [n for n, free in self._free.items() if free and n >= nbytes]
        if fits:
            return self._free[min(fits)].pop()
        while self.held + nbytes > self.budget:
            # Room from a free slot too small.
            other = next((n for n, f in self._free.items() if f), None)
            if other is None:
                return None
            self._free[other].pop()
            self.held -= other
        self.held += nbytes
        self.peak = max(self.peak, self.held)
        trace.count("reader.slot_allocs", 1)
        return _Slot(nbytes)

    async def take(self, nbytes: int) -> _Slot | None:
        """A slot of at least ``nbytes`` (a padded block length, an EC
        block's rows); None for a block larger than the whole budget, which
        lands in fresh memory."""
        nbytes = self.size_of(nbytes)
        if nbytes > self.budget:
            return None
        counted = False
        while True:
            with self._lock:
                slot = self._take_locked(nbytes)
                if slot is None:
                    loop = asyncio.get_running_loop()
                    woken = loop.create_future()
                    self._waiters.append((loop, woken))
            if slot is not None:
                return slot
            if not counted:
                trace.count("reader.slot_waits", 1)
                counted = True
            await woken

    def give(self, slot: _Slot, keep: bool = True) -> None:
        """``slot`` back to the pool; ``keep=False`` drops it instead (its
        memory goes once nothing refers to it), freeing its bytes of the
        budget. Wakes every waiter to try again."""
        with self._lock:
            if keep:
                self._free.setdefault(slot.nbytes, []).append(slot)
            else:
                self.held -= slot.nbytes
            waiters, self._waiters = self._waiters, []
        for loop, woken in waiters:
            try:
                loop.call_soon_threadsafe(_wake, woken)
            except RuntimeError:  # its loop has closed
                pass


class DeviceBlock:
    """One block's words on one device: its own (chunks, 128) uint32
    tensor, or a slice on demand of a fused :class:`DeviceBatch` (the
    batched paths). ``pending_crc`` / ``batch_pending`` mark lazy
    verification: the 0-d (or batch-vector) on-device CRC fold is resolved
    against ``expected_crc`` by :meth:`HbmReader.confirm`, on the host,
    with one device→host copy per confirm call."""

    def __init__(self, block_id: str, array: torch.Tensor | None, size: int,
                 verified: bool, *, pending_crc: torch.Tensor | None = None,
                 expected_crc: int | None = None, source: dict | None = None,
                 device: torch.device | None = None,
                 batch: DeviceBatch | None = None, batch_index: int = 0,
                 batch_pending: bool = False):
        self.block_id = block_id
        self._array = array
        self.size = size  # unpadded byte length
        self.verified = verified
        self.pending_crc = pending_crc
        self.expected_crc = expected_crc
        #: source block metadata + target device, kept so a failed lazy
        #: verify can be retried through the host-verified fetch path.
        self.source = source
        self.device = device
        #: fused-round fields: the DeviceBatch this block rides in, its
        #: index there, and whether its verdict is still unresolved in the
        #: batch's (n,) CRC vector.
        self.batch = batch
        self.batch_index = batch_index
        self.batch_pending = batch_pending

    @property
    def array(self) -> torch.Tensor:
        """(chunks, 128) uint32 words; a batched block slices its round on
        first use."""
        if self._array is None and self.batch is not None:
            self._array = self.batch.block_words(self.batch_index)
        return self._array

    @array.setter
    def array(self, value: torch.Tensor) -> None:
        self._array = value
        self.batch = None

    @property
    def sync_arrays(self) -> list:
        """Device tensors a completion wait must cover for this block,
        without slicing a fused batch."""
        if self.batch is not None and self._array is None:
            out = [self.batch.words]
            if self.batch.crcs is not None:
                out.append(self.batch.crcs)
            return out
        out = [self._array]
        if self.pending_crc is not None:
            out.append(self.pending_crc)
        return out


class HbmReader:
    def __init__(self, client, devices: list | None = None, *,
                 batch_reads: int = 0):
        self.client = client
        self.devices = ([resolve_device(d) for d in devices]
                        if devices is not None else [resolve_device()])
        #: Blocks re-read through the host-verified path after their device
        #: check failed (eagerly or at confirm).
        self.rereads = 0
        #: Degraded EC blocks rebuilt on the device (one GF(2^8) decode
        #: each: the kernel on a card, its plain twin on the CPU).
        self.ec_rebuilds = 0
        #: >0 enables the fused read path (one ReadCombiner per device,
        #: max_batch=batch_reads) for lazily verified reads; 0 keeps every
        #: block on the per-block path.
        self.batch_reads = batch_reads
        self._combiners: dict[torch.device, ReadCombiner] = {}
        #: Landing slots of the per-block path, one pool per device.
        self._pools: dict[torch.device, SlotPool] = {}
        #: blocks served by the native sweep pump.
        self.sweep_blocks = 0
        #: Wall seconds of the sweep's consumer, summed over rounds and
        #: sweeps: waiting for the producer to fill a round
        #: (``producer_wait``), enqueueing its copy (``copy``), waiting for
        #: a recycled slot's copy to complete (``slot_wait``), and the
        #: per-block fallbacks (``fallback``): the spans ``sweep.<key>``.
        self.sweep_stage_s = dict.fromkeys(
            ("producer_wait", "copy", "slot_wait", "fallback"), 0.0)

    def _combiner(self, device) -> ReadCombiner:
        device = resolve_device(device)
        c = self._combiners.get(device)
        if c is None:
            c = ReadCombiner(self.client, device, max_batch=self.batch_reads)
            self._combiners[device] = c
        return c

    def _slot_pool(self, device: torch.device) -> SlotPool:
        pool = self._pools.get(device)
        if pool is None:
            pool = self._pools.setdefault(
                device, SlotPool(pinned=device.type == "cuda"))
        return pool

    async def _try_batched(self, block: dict, device,
                           verify: bool | str) -> DeviceBlock | None:
        """Fused-round read when enabled and the block qualifies (lazy
        verify, chunk-aligned; a colocated replica or a remote peer's
        batched ReadBlocks frame). None -> per-block path."""
        if not self.batch_reads or verify != "lazy":
            return None
        combiner = self._combiner(device)
        rode = await combiner.read(block)
        if rode is None:
            return None
        batch, index = rode
        # The verdict waits for confirm unless the round was verified on
        # the host, which leaves it no CRC vector; a round that a confirm
        # has already resolved lost its vector there.
        pending = batch.crcs is not None or batch.resolved is not None
        return DeviceBlock(block["block_id"], None, int(block["size"]),
                           not pending,
                           expected_crc=int(block["checksum_crc32c"]),
                           source=block, device=combiner.device,
                           batch=batch, batch_index=index,
                           batch_pending=pending)

    def warm_batches(self, cpb: int) -> None:
        """Allocate every round size's pooled buffer and load the CRC
        kernel's library and tables on every device (nothing launched), so
        the first timed round pays neither."""
        if self.batch_reads:
            for device in self.devices:
                self._combiner(device).warm(cpb)

    # ------------------------------------------------------------ per block

    async def read_block_to_device(self, block: dict, device,
                                   verify: bool | str = True, *,
                                   safe_local: bool = False) -> DeviceBlock:
        """``verify``: False = no check; True = eager (syncs this block's
        device CRC now); ``"lazy"`` = launch the on-device check but defer
        the host sync to a later batched ``confirm`` call.

        ``safe_local``: force the host-verified short-circuit path (used by
        the corruption retry; normally the on-device check subsumes it)."""
        async with trace.span("reader.block") as sp:
            if not safe_local:
                db = await self._try_batched(block, device, verify)
                if db is not None:
                    sp.nbytes = db.size
                    return db
            try:
                db = await self._read_block_inner(block, device, verify,
                                                  safe_local)
            except ChecksumMismatchError:
                # The fast path trusts the device CRC end to end; a mismatch
                # may be a corrupt LOCAL replica that the host-verified path
                # would have skipped. Retry once through that path.
                if safe_local:
                    raise
                self.rereads += 1
                try:
                    db = await self._read_block_inner(block, device, verify,
                                                      True)
                except Exception as e2:
                    if not is_dfs_error(e2):
                        raise
                    raise DfsError(
                        f"on-device checksum mismatch for block "
                        f"{block['block_id']} (verified-path retry failed: "
                        f"{e2})"
                    ) from None
            db.source = block
            db.device = device
            sp.nbytes = db.size
            return db

    async def _read_block_inner(self, block: dict, device,
                                verify: bool | str,
                                safe_local: bool) -> DeviceBlock:
        if block.get("ec_data_shards"):
            words, size = await self._ec_block_to_device(
                block, device, verify, safe_local
            )
            return await self._finish_block(block, words, size, verify)
        # When the device fold verifies this block end to end, a local read
        # skips the host sidecar pass (bit-rot surfaces at the device check).
        device_verify = bool(verify) and bool(block.get("checksum_crc32c"))
        device = resolve_device(device)
        expect = int(block.get("size") or 0)
        pool = self._slot_pool(device)
        # Taken here, on the loop: a worker never waits for a slot.
        slot = await pool.take(padded_len(expect)) if expect > 0 else None
        # Taken (never released) by the first attempt at the block that
        # fits in the slot, or by the read itself once it is over; another
        # attempt (a hedge, a second replica) lands in a fresh grid.
        claim = threading.Lock()
        landed = data = None

        def _grid(nbytes: int) -> np.ndarray:
            nonlocal landed
            with trace.span("reader.grid"):
                if slot is not None and padded_len(nbytes) <= slot.nbytes \
                        and claim.acquire(blocking=False):
                    landed = slot.landing(nbytes, pool.pinned)
                    return landed
                # Chunk-padded grid the bytes land in: the returned view's
                # .base is the padded array, so no pad-copy is needed after.
                arr = np.zeros(padded_len(nbytes), dtype=np.uint8)
                return arr[:nbytes]

        try:
            data = await self.client._read_block_range(
                block, 0, 0, local_verify=safe_local or not device_verify,
                into=_grid,
            )
            size = len(data)
            if landed is not None and data is landed:
                # Enqueued from the loop: a copy from pinned memory does
                # not wait for the transfer.
                words, slot.copied = reused_to_device(slot.words(size),
                                                      device)
                words = words.view(torch.uint32)
            else:
                if isinstance(data, np.ndarray):
                    grid = data.base if data.base is not None else data
                    words_np = grid.view("<u4").reshape(-1, WORDS_PER_CHUNK)
                else:
                    # A client that delivered bytes (the reference's gRPC
                    # path).
                    words_np = bytes_to_words(data)
                # Off the event loop: the host->device copy of a pageable
                # buffer blocks for the whole transfer.
                words = await asyncio.to_thread(host_to_device, words_np,
                                                device)
            return await self._finish_block(block, words, size, verify)
        finally:
            if slot is not None:
                # The claim decides who owns the slot. Taken here, it bars
                # any later attempt. Taken by an attempt whose bytes were
                # not returned (one cancelled with the read, a losing
                # hedge), whose worker may still be writing there: the
                # slot is dropped, not pooled.
                pool.give(slot, keep=claim.acquire(blocking=False)
                          or (landed is not None and data is landed))

    async def _ec_block_to_device(self, block: dict, device,
                                  verify: bool | str = True,
                                  safe_local: bool = False):
        """EC block → device words. The shards land in a slot of the
        reader's pool as k rows of the decode kernel's width (the shard
        length rounded up to 128 bytes, ``pad_shard_len``):
        row i holds data shard i, or, where that shard is missing or
        unreadable, a parity shard. The rows go up in one copy, enqueued
        from the loop. All data shards in their rows: the rows are the
        block's chunk grid (the device drops the rows' pads, where they
        have any). Otherwise kernel 2 rebuilds the data rows on the device
        from the inverse for the rows' own code-word indices.

        A client with ``lands_ec_rows`` reads each shard straight into its
        row (``_read_ec_shards``'s ``rows``: every read has ended when the
        call returns); from any other, the shards returned as bytes are
        copied into the rows in a worker."""
        k = int(block["ec_data_shards"])
        m = int(block["ec_parity_shards"])
        size = int(block.get("original_size") or block.get("size") or 0)
        slen = -(-size // k)
        stride = pad_shard_len(slen)  # the decode kernel's row width
        need = padded_len(size)
        nbytes = max(k * stride, need)
        device = resolve_device(device)
        device_verify = bool(verify) and bool(block.get("checksum_crc32c"))
        pool = self._slot_pool(device)
        # Taken here, on the loop: a worker never waits for a slot.
        slot = await pool.take(nbytes)
        pooled = slot is not None
        if not pooled:  # a block larger than the whole budget
            slot = _Slot(nbytes)
        handed: list = [None] * k  # each row's last view handed to a read
        rows = None

        def land(r: int, n: int) -> np.ndarray:
            if n != slen:
                raise ChecksumMismatchError(
                    f"EC block {block['block_id']}: a {n}-byte shard, "
                    f"{slen} expected")
            handed[r] = rows[r, :n]
            return handed[r]

        def prepare() -> np.ndarray:
            with trace.span("ec.stack"):
                return slot.rows(k, slen, stride, nbytes,
                                 pooled and pool.pinned)

        # True while a worker that may write the slot has not been seen to
        # end (a cancelled read's): its slot is then dropped, not pooled.
        writing = True
        try:
            rows = await asyncio.to_thread(prepare)
            extra = {"rows": land} \
                if getattr(self.client, "lands_ec_rows", False) else {}
            async with trace.span("ec.read_shards") as sp:
                shards = await self.client._read_ec_shards(
                    block, local_verify=safe_local or not device_verify,
                    **extra)
                writing = False
                sp.nbytes = got = sum(len(s) for s in shards
                                      if s is not None)
            trace.count("ec.shard_bytes", got)
            order, copies = _place_rows(shards, handed, slen)
            if None in order:
                raise DfsError(
                    f"EC block {block['block_id']}: only "
                    f"{k - order.count(None)} of {k}+{m} shards available")
            if copies:
                def copy_in():
                    with trace.span("ec.stack"):
                        for r, data in copies:
                            rows[r, :slen] = np.frombuffer(data,
                                                           dtype=np.uint8)

                writing = True
                await asyncio.to_thread(copy_in)
                writing = False
            trace.count("ec.rows_landed", k - len(copies))
            trace.count("ec.rows_copied", len(copies))
            if pooled:
                with trace.span("ec.upload"):
                    up, slot.copied = reused_to_device(slot.buf[:nbytes],
                                                       device)
            else:  # pageable: the copy blocks for the whole transfer
                up, _ = await asyncio.to_thread(reused_to_device,
                                                slot.buf[:nbytes], device)
        finally:
            if pooled:
                pool.give(slot, keep=not writing)
        data_rows = up[:k * stride].view(k, stride)
        if order == list(range(k)):
            trace.count("ec.blocks_assembled", 1)
            # Rows with no pad are the chunk grid, its tail zeroed.
            return _grid_words(up if stride == slen
                               else data_rows[:, :slen].reshape(-1),
                               need), size
        with trace.span("ec.decode"):
            recon = rs_decode_device(data_rows, k, m, tuple(order))
            words = _grid_words(recon[:, :slen].reshape(-1), need)
        self.ec_rebuilds += 1
        trace.count("ec.blocks_rebuilt", 1)
        return words, size

    async def _finish_block(self, block: dict, words: torch.Tensor, size: int,
                            verify: bool | str) -> DeviceBlock:
        # verified means "an on-device CRC check ran and passed"; a block
        # with no recorded checksum was NOT verified.
        verified = False
        pending: torch.Tensor | None = None
        expected: int | None = None
        if verify and block.get("checksum_crc32c"):
            expected = int(block["checksum_crc32c"])
            async with trace.span("reader.verify"):
                if size % CHECKSUM_CHUNK_SIZE == 0:
                    # Device fold: whole-block CRC with no chunk readback;
                    # compared on the host.
                    crc = block_crc_device(words)
                    if verify == "lazy":
                        pending = crc
                    else:
                        got = await asyncio.to_thread(
                            lambda: int(u32_to_numpy(crc.reshape(1))[0]))
                        verified = got == expected
                else:
                    # The tail chunk was zero-padded on the device, so the
                    # fold diverges from the stored CRC: rebuild the tail
                    # on the host. Eager even under "lazy" (nothing to
                    # defer), so it must raise here: confirm() only
                    # inspects pending_crc.
                    verified = await asyncio.to_thread(
                        self._verify_host_tail_block, words, size, expected
                    )
            if pending is None and not verified:
                raise ChecksumMismatchError(
                    f"on-device checksum mismatch for block {block['block_id']}"
                )
        return DeviceBlock(block["block_id"], words, size, verified,
                           pending_crc=pending, expected_crc=expected)

    async def confirm(self, blocks: list[DeviceBlock], *,
                      retry: bool = True) -> None:
        """Resolve every lazy verification with ONE device→host copy: the
        pending 0-d CRCs of single blocks and the (n,) CRC vectors of fused
        rounds are gathered on the first device, concatenated, and copied
        to the host together, then compared there. A round resolved by an
        earlier call keeps its resolution (a second confirm copies nothing).

        A failed block is retried once through the host-verified fetch path
        (``retry=False`` disables), where a corrupt local replica is
        skipped for a healthy one; the re-reads run concurrently. Raises
        DfsError naming each block that could not be recovered; marks the
        rest verified."""
        singles = [b for b in blocks if b.pending_crc is not None]
        batched = [b for b in blocks if b.batch_pending and b.batch is not None]
        if not singles and not batched:
            return
        # Unresolved batches, deduped by identity, in first-seen order.
        groups: list[DeviceBatch] = []
        for b in batched:
            if b.batch.resolved is None and \
                    not any(g is b.batch for g in groups):
                groups.append(b.batch)
        home = self.devices[0]
        parts = [b.pending_crc.view(torch.int32).reshape(1).to(home)
                 for b in singles]
        parts += [g.crcs.view(torch.int32).to(home) for g in groups]

        def fetch() -> np.ndarray:
            return torch.cat(parts).cpu().numpy().view(np.uint32)

        got = await asyncio.to_thread(fetch) if parts \
            else np.empty(0, dtype=np.uint32)
        bad = []
        for i, b in enumerate(singles):
            b.pending_crc = None
            b.verified = int(got[i]) == b.expected_crc
            if not b.verified:
                bad.append(b)
        off = len(singles)
        for g in groups:
            g.resolved = got[off : off + g.nblocks]
            g.crcs = None
            off += g.nblocks
        for b in batched:
            b.batch_pending = False
            b.verified = int(b.batch.resolved[b.batch_index]) == b.expected_crc
            if not b.verified:
                bad.append(b)

        async def _reread(b):
            try:
                return await self.read_block_to_device(
                    b.source, b.device, verify=True, safe_local=True
                )
            except Exception as e:
                if not is_dfs_error(e):
                    raise
                return None

        retryable = [
            b for b in bad
            if retry and b.source is not None and b.device is not None
        ]
        self.rereads += len(retryable)
        results = await asyncio.gather(*(_reread(b) for b in retryable))
        fixed = {id(b): nb for b, nb in zip(retryable, results)}
        unrecovered = []
        for b in bad:
            nb = fixed.get(id(b))
            if nb is not None:
                b.array, b.size, b.verified = nb.array, nb.size, nb.verified
            else:
                unrecovered.append(b.block_id)
        if unrecovered:
            raise DfsError(
                "on-device checksum mismatch for blocks: "
                + ", ".join(unrecovered)
            )

    def _verify_host_tail_block(self, words: torch.Tensor, size: int,
                                expected_crc: int) -> bool:
        chunk_crcs = u32_to_numpy(crc32c_chunks_device(words))
        full_chunks = size // CHECKSUM_CHUNK_SIZE
        crc = crc32c_combine_chunks(chunk_crcs[:full_chunks], CHECKSUM_CHUNK_SIZE)
        tail_len = size - full_chunks * CHECKSUM_CHUNK_SIZE
        if tail_len:
            tail = words[full_chunks:].contiguous().view(torch.uint8) \
                .reshape(-1)[:tail_len].cpu().numpy()
            crc = crc32c_combine(crc, crc32c(tail), tail_len)
        return crc == expected_crc

    # ------------------------------------------------- cached metadata

    async def read_meta_blocks_fast(
        self, meta: dict, device=None, verify: bool | str = "lazy",
    ) -> list[DeviceBlock]:
        """Steady-state read of a file whose metadata the caller CACHED (no
        master round-trip): every block through :meth:`read_block_to_device`
        at once. Returns lazy-verified DeviceBlocks under the default
        ``verify``; resolve them with ``confirm``."""
        device = device or self.devices[0]
        return list(await asyncio.gather(
            *(self.read_block_to_device(b, device, verify=verify)
              for b in meta["blocks"])
        ))

    # ---------------------------------------------------- native sweep pump

    async def sweep_metas_to_device(self, metas: list[dict], device=None, *,
                                    round_blocks: int = 16,
                                    ring: int = 3) -> list[DeviceBlock]:
        """Steady-state sweep infeed, native end to end: every eligible
        block of every file is handed to the native sweep pump
        (``native/blockio.cc`` ``tpudfs_sweep_*``) once. Its producer
        thread runs the fused pread + CRC into a ring of round buffers ahead
        of this coroutine, whose per-round work is one wait (usually
        already satisfied), one vectorized verify, one copy to the device
        and one release.

        Blocks that do not qualify (EC, no colocated replica, unaligned
        tail, CRC mismatch, short read) fall back to the per-block path
        with its recovery. Returns DeviceBlocks in (file, block) order,
        verified on the host (nothing pending for ``confirm``).

        The ring is pinned host memory on a card (PyTorch's caching host
        allocator hands a finished sweep's buffers to the next one), and a
        slot is released to the producer only after an event recorded
        behind its round's copy has completed. On the CPU device each round
        is cloned out of the ring."""
        device = resolve_device(device or self.devices[0])
        lib = native.lib()

        # ---- eligibility + local path resolution (meta order preserved)
        entries: list = []   # (slot_index | None, block) per (file, block)
        paths: list[str] = []
        expected_sizes: list[int] = []
        expected_crcs: list[int] = []
        stores: dict[str, object] = {}  # addr -> store|None, sweep-local
        for meta in metas:
            for block in meta["blocks"]:
                size = int(block.get("size") or 0)
                store = None
                if (self.client.local_reads
                        and not block.get("ec_data_shards")
                        and block.get("checksum_crc32c")
                        and size > 0 and size % CHECKSUM_CHUNK_SIZE == 0):
                    for addr in block.get("locations") or []:
                        if not addr:
                            continue
                        if addr in stores:
                            s = stores[addr]
                        else:
                            s = await self.client._local_store(addr)
                            stores[addr] = s
                        if s is not None:
                            store = s
                            break
                if store is None:
                    entries.append((None, block))
                    continue
                try:
                    # No-probe hot-tier path: a cold-tier or missing block
                    # fails its pread and takes the per-block fallback.
                    bpath = store.hot_path_str(block["block_id"])
                except ValueError:
                    entries.append((None, block))
                    continue
                entries.append((len(paths), block))
                paths.append(bpath)
                expected_sizes.append(size)
                expected_crcs.append(int(block["checksum_crc32c"]))

        fallback_idx = [i for i, (slot, _b) in enumerate(entries)
                        if slot is None]
        results: list = [None] * len(entries)
        n = len(paths)
        if n:
            stride = max(expected_sizes)
            spb = stride // CHECKSUM_CHUNK_SIZE  # slot rows
            bufs = [torch.empty(round_blocks * stride, dtype=torch.uint8,
                                pin_memory=device.type == "cuda")
                    for _ in range(ring)]
            buf_words = [b.view(torch.int32).view(-1, WORDS_PER_CHUNK)
                         for b in bufs]
            sizes = np.zeros(n, dtype=np.int64)
            crcs = np.zeros(n, dtype=np.uint32)
            cpaths = native.c_paths(paths)
            cbufs = (ctypes.c_void_p * ring)(*(b.data_ptr() for b in bufs))
            exp_sizes = np.asarray(expected_sizes, dtype=np.int64)
            exp_crcs = np.asarray(expected_crcs, dtype=np.uint32)
            slot_entry = [i for i, (slot, _b) in enumerate(entries)
                          if slot is not None]
            handle = lib.tpudfs_sweep_start(
                cpaths, n, stride, round_blocks, cbufs, ring,
                sizes.ctypes.data, crcs.ctypes.data)
            nrounds = -(-n // round_blocks)
            copied: list = [None] * nrounds  # copy-done event per round
            try:
                stage = self.sweep_stage_s
                for r in range(nrounds):
                    if r >= ring:
                        # The recycled slot's copy must have COMPLETED
                        # before the producer refills it.
                        async with trace.span("sweep.slot_wait",
                                              stages=stage):
                            await asyncio.to_thread(wait_events,
                                                    [copied[r - ring]])
                            lib.tpudfs_sweep_release(handle, r - ring)
                    async with trace.span("sweep.producer_wait",
                                          stages=stage):
                        nblk = await asyncio.to_thread(
                            lib.tpudfs_sweep_wait, handle, r)
                    if nblk < 0:
                        break
                    with trace.span("sweep.copy", stages=stage):
                        lo = r * round_blocks
                        hi = lo + nblk
                        ok = (sizes[lo:hi] == exp_sizes[lo:hi]) \
                            & (crcs[lo:hi] == exp_crcs[lo:hi])
                        words, copied[r] = reused_to_device(
                            buf_words[r % ring][: nblk * spb], device)
                    batch = DeviceBatch(words=words.view(torch.uint32),
                                        crcs=None, cpb=spb, nblocks=nblk)
                    for j in range(nblk):
                        slot = lo + j
                        eidx = slot_entry[slot]
                        _s, block = entries[eidx]
                        if not ok[j]:
                            fallback_idx.append(eidx)
                            continue
                        results[eidx] = DeviceBlock(
                            block["block_id"], None,
                            int(exp_sizes[slot]), True,
                            expected_crc=int(exp_crcs[slot]),
                            source=block, device=device,
                            batch=batch, batch_index=j,
                            batch_pending=False)
                        self.sweep_blocks += 1
            finally:
                # Completion before stop: a copy may still be reading a
                # ring buffer.
                await asyncio.to_thread(wait_events, copied)
                lib.tpudfs_sweep_stop(handle)

        if fallback_idx:
            async def fb(eidx: int):
                _slot, block = entries[eidx]
                results[eidx] = await self.read_block_to_device(
                    block, device, verify=True)

            async with trace.span("sweep.fallback",
                                  stages=self.sweep_stage_s):
                await asyncio.gather(*(fb(i) for i in fallback_idx))
        return results

    async def sweep_paths_to_device(self, paths: list[str], device=None, *,
                                    round_blocks: int = 16,
                                    ring: int = 3) -> list[DeviceBlock]:
        """:meth:`sweep_metas_to_device` with the metadata fan-out in front
        (nothing cached: metadata fetched in the sweep, then the native pump
        drives the data plane)."""
        metas = await asyncio.gather(
            *(self.client.get_file_info(p) for p in paths))
        missing = [p for p, m in zip(paths, metas) if m is None]
        if missing:
            raise DfsError(f"file not found: {missing[0]}")
        return await self.sweep_metas_to_device(
            metas, device, round_blocks=round_blocks, ring=ring)

    # ------------------------------------------------------------- per file

    async def read_file_to_device_blocks(
        self, path: str, verify: bool | str = True,
        placement: str = "round_robin",
    ) -> list[DeviceBlock]:
        """Fetch every block concurrently with per-block device placement.
        ``round_robin``: block i → device i % n. ``contiguous``: block i →
        device i // ceil(blocks/n) (file order within each device, as
        :meth:`read_file_sharded` needs)."""
        meta = await self.client.get_file_info(path)
        if meta is None:
            raise DfsError(f"file not found: {path}")
        blocks = meta["blocks"]
        n = len(self.devices)
        if placement == "contiguous":
            per = -(-len(blocks) // n) if blocks else 1
            device_of = lambda i: self.devices[i // per]  # noqa: E731
        else:
            device_of = lambda i: self.devices[i % n]  # noqa: E731
        return list(await asyncio.gather(*(
            self.read_block_to_device(block, device_of(i), verify=verify)
            for i, block in enumerate(blocks)
        )))

    async def read_file_sharded(self, path: str,
                                verify: bool | str = True) -> list[torch.Tensor]:
        """Whole file as one (per_group * max_chunks, 128) uint32 tensor per
        device, IN FILE ORDER across the list (the port of the reference's
        sharded ``jax.Array``: device d holds the d-th contiguous group of
        blocks, concatenated on that device; short blocks and missing group
        slots pad with zero chunks so every shard has the same shape)."""
        dblocks = await self.read_file_to_device_blocks(
            path, verify=verify, placement="contiguous"
        )
        await self.confirm(dblocks)  # one sync even in lazy mode
        if not dblocks:
            raise DfsError(f"file has no blocks: {path}")
        ndev = len(self.devices)
        max_chunks = max(b.array.shape[0] for b in dblocks)
        per = -(-len(dblocks) // ndev)
        groups: list[list[torch.Tensor]] = [[] for _ in range(ndev)]
        for i, b in enumerate(dblocks):
            groups[i // per].append(b.array.view(torch.int32))
        per_group = max(len(g) for g in groups)
        shards = []
        for device, group in zip(self.devices, groups):
            parts = []
            for arr in group:
                parts.append(arr)
                if arr.shape[0] < max_chunks:
                    parts.append(arr.new_zeros(
                        (max_chunks - arr.shape[0], WORDS_PER_CHUNK)))
            if len(group) < per_group:
                parts.append(torch.zeros(
                    ((per_group - len(group)) * max_chunks, WORDS_PER_CHUNK),
                    dtype=torch.int32, device=device))
            shards.append(torch.cat(parts).view(torch.uint32))
        return shards


def _place_rows(shards: list, handed: list, slen: int):
    """Each row's code-word index (None: no shard for the row) and the
    (row, bytes) pairs to copy in, from ``_read_ec_shards``'s slots: a
    shard that a read landed in a row stays there; one returned as bytes
    goes to its own row if a data shard, else to the first row still
    empty; one of another length than ``slen`` is left out."""
    k = len(handed)
    order: list = [None] * k
    loose = []
    for i, s in enumerate(shards):
        if s is None:
            continue
        r = next((r for r, v in enumerate(handed) if v is s), None)
        if r is not None:
            order[r] = i
        elif len(s) == slen:
            loose.append((i, s))
    copies = []
    for i, s in loose:
        empty = [r for r in range(k) if order[r] is None]
        if not empty:
            break
        r = i if i in empty else empty[0]
        order[r] = i
        copies.append((r, s))
    return order, copies


def _grid_words(flat: torch.Tensor, need: int) -> torch.Tensor:
    """A block's bytes on the device, ``flat`` (uint8), as its chunk grid
    of ``need`` bytes: (chunks, 128) uint32, zero-padded past ``flat``.
    The shards' own zero padding makes the bytes past the block's size
    zeros (``bytes_to_words`` pads the same way)."""
    if flat.shape[0] < need:
        flat = torch.cat([flat, flat.new_zeros(need - flat.shape[0])])
    return flat[:need].view(torch.uint32).view(-1, WORDS_PER_CHUNK)


def device_array_to_bytes(arr: torch.Tensor, size: int) -> bytes:
    """Host copy-out (for tests / tools): unpad the device words."""
    return arr.contiguous().view(torch.uint8).reshape(-1)[:size].cpu() \
        .numpy().tobytes()
