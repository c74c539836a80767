"""DFS → GPU memory reader: blocks land as device tensors, verified on the
device — port of ``tpudfs/tpu/hbm_reader.py`` (the per-block path).

Each block's bytes go from the fetch buffer (a zero-padded chunk grid the
client reads straight into) to its target device in one copy. The
per-512-byte-chunk CRC32C runs on the device (kernel 1, ``crc32c.cu``), and
a GF(2) combine-fold turns the chunk CRCs into the whole-block checksum
recorded at CompleteFile, with no host readback. Under ``verify="lazy"``
every block's verdict stays on the device until :meth:`HbmReader.confirm`
settles them all with one device→host copy. A degraded erasure-coded block
is rebuilt on the device with kernel 2 (``gf256.cu``).

The client is duck-typed: ``tpudfs_torch.client.local.LocalClient`` (the
colocated short-circuit read) or the reference ``tpudfs.client.Client``.
Not in this port yet: the fused-round combiner (``read_combiner.py``; every
block takes the per-block path) and the native sweep pump.
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np
import torch

from tpudfs_torch.client.local import ChecksumMismatchError, DfsError, is_dfs_error
from tpudfs_torch.common.checksum import (
    CHECKSUM_CHUNK_SIZE,
    crc32c,
    crc32c_combine,
    crc32c_combine_chunks,
)
from tpudfs_torch.gpu import host_to_device, resolve_device, u32_to_numpy
from tpudfs_torch.gpu.crc32c_cuda import (
    WORDS_PER_CHUNK,
    block_crc_device,
    bytes_to_words,
    crc32c_chunks_device,
)
from tpudfs_torch.gpu.rs_cuda import pad_shard_len, rs_decode_device

logger = logging.getLogger(__name__)


class DeviceBlock:
    """One block's words on one device: a (chunks, 128) uint32 tensor.
    ``pending_crc`` marks lazy verification: the 0-d on-device CRC fold is
    resolved against ``expected_crc`` by :meth:`HbmReader.confirm`, on the
    host, with one device→host copy per confirm call."""

    def __init__(self, block_id: str, array: torch.Tensor, size: int,
                 verified: bool, *, pending_crc: torch.Tensor | None = None,
                 expected_crc: int | None = None, source: dict | None = None,
                 device: torch.device | None = None):
        self.block_id = block_id
        self.array = array
        self.size = size  # unpadded byte length
        self.verified = verified
        self.pending_crc = pending_crc
        self.expected_crc = expected_crc
        #: source block metadata + target device, kept so a failed lazy
        #: verify can be retried through the host-verified fetch path.
        self.source = source
        self.device = device


class HbmReader:
    def __init__(self, client, devices: list | None = None):
        self.client = client
        self.devices = ([resolve_device(d) for d in devices]
                        if devices is not None else [resolve_device()])
        #: Blocks re-read through the host-verified path after their device
        #: check failed (eagerly or at confirm).
        self.rereads = 0

    # ------------------------------------------------------------ per block

    async def read_block_to_device(self, block: dict, device,
                                   verify: bool | str = True, *,
                                   safe_local: bool = False) -> DeviceBlock:
        """``verify``: False = no check; True = eager (syncs this block's
        device CRC now); ``"lazy"`` = launch the on-device check but defer
        the host sync to a later batched ``confirm`` call.

        ``safe_local``: force the host-verified short-circuit path (used by
        the corruption retry; normally the on-device check subsumes it)."""
        try:
            db = await self._read_block_inner(block, device, verify,
                                              safe_local)
        except ChecksumMismatchError:
            # The fast path trusts the device CRC end to end; a mismatch may
            # be a corrupt LOCAL replica that the host-verified path would
            # have skipped. Retry once through that path.
            if safe_local:
                raise
            self.rereads += 1
            try:
                db = await self._read_block_inner(block, device, verify, True)
            except Exception as e2:
                if not is_dfs_error(e2):
                    raise
                raise DfsError(
                    f"on-device checksum mismatch for block "
                    f"{block['block_id']} (verified-path retry failed: {e2})"
                ) from None
        db.source = block
        db.device = device
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

        def _grid(nbytes: int) -> np.ndarray:
            # Chunk-padded grid the bytes land in: the returned view's
            # .base is the padded array, so no pad-copy is needed after.
            pad = -nbytes % CHECKSUM_CHUNK_SIZE
            arr = np.zeros(max(nbytes + pad, CHECKSUM_CHUNK_SIZE),
                           dtype=np.uint8)
            return arr[:nbytes]

        data = await self.client._read_block_range(
            block, 0, 0, local_verify=safe_local or not device_verify,
            into=_grid,
        )
        size = len(data)
        if isinstance(data, np.ndarray):
            grid = data.base if data.base is not None else data
            words_np = grid.view("<u4").reshape(-1, WORDS_PER_CHUNK)
        else:
            # A client that delivered bytes (the reference's gRPC path).
            words_np = bytes_to_words(data)
        # Off the event loop: the host->device copy of a pageable buffer
        # blocks for the whole transfer.
        words = await asyncio.to_thread(host_to_device, words_np, device)
        return await self._finish_block(block, words, size, verify)

    async def _ec_block_to_device(self, block: dict, device,
                                  verify: bool | str = True,
                                  safe_local: bool = False):
        """EC block → device words. All data shards present: host concat
        into the chunk grid + one upload. Degraded: upload the k surviving
        shards and reconstruct on the device with kernel 2."""
        k = int(block["ec_data_shards"])
        m = int(block["ec_parity_shards"])
        size = int(block.get("original_size") or block.get("size") or 0)
        device_verify = bool(verify) and bool(block.get("checksum_crc32c"))
        shards = await self.client._read_ec_shards(
            block, local_verify=safe_local or not device_verify
        )
        if all(s is not None for s in shards[:k]):
            def _assemble():
                need = -(-max(size, 1) // CHECKSUM_CHUNK_SIZE) \
                    * CHECKSUM_CHUNK_SIZE
                buf = np.zeros(need, dtype=np.uint8)
                off = 0
                for s in shards[:k]:
                    take = min(len(s), size - off)
                    if take <= 0:
                        break
                    buf[off : off + take] = \
                        np.frombuffer(s, dtype=np.uint8, count=take)
                    off += take
                return host_to_device(
                    buf.view("<u4").reshape(-1, WORDS_PER_CHUNK), device)

            return await asyncio.to_thread(_assemble), size
        present = tuple(i for i, s in enumerate(shards) if s is not None)
        if len(present) < k:
            raise DfsError(
                f"EC block {block['block_id']}: only {len(present)} of "
                f"{k}+{m} shards available"
            )
        use = present[:k]
        slen = len(shards[use[0]])
        stack = np.zeros((k, pad_shard_len(slen)), dtype=np.uint8)
        for r, idx in enumerate(use):
            row = np.frombuffer(shards[idx], dtype=np.uint8)
            if len(row) != slen:
                raise ChecksumMismatchError(
                    f"EC block {block['block_id']}: shard length mismatch"
                )
            stack[r, :slen] = row

        def reconstruct():
            avail = torch.from_numpy(stack).to(device)
            recon = rs_decode_device(avail, k, m, use)  # (k, padded)
            nchunks = -(-size // CHECKSUM_CHUNK_SIZE) or 1
            need = nchunks * CHECKSUM_CHUNK_SIZE
            flat = recon[:, :slen].reshape(-1)
            if flat.shape[0] < need:
                flat = torch.cat([flat, flat.new_zeros(need - flat.shape[0])])
            # Shard zero-padding means flat[size:] is zeros, so the slice
            # to the chunk grid is exact (bytes_to_words pads the same way).
            return flat[:need].view(torch.uint32).view(nchunks, WORDS_PER_CHUNK)

        return await asyncio.to_thread(reconstruct), size

    async def _finish_block(self, block: dict, words: torch.Tensor, size: int,
                            verify: bool | str) -> DeviceBlock:
        # verified means "an on-device CRC check ran and passed"; a block
        # with no recorded checksum was NOT verified.
        verified = False
        pending: torch.Tensor | None = None
        expected: int | None = None
        if verify and block.get("checksum_crc32c"):
            expected = int(block["checksum_crc32c"])
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
                # The tail chunk was zero-padded on the device, so the fold
                # diverges from the stored CRC: rebuild the tail on the
                # host. Eager even under "lazy" (nothing to defer), so it
                # must raise here: confirm() only inspects pending_crc.
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
        pending 0-d CRCs are gathered on the first device, stacked, and
        copied to the host together, then compared there.

        A failed block is retried once through the host-verified fetch path
        (``retry=False`` disables), where a corrupt local replica is
        skipped for a healthy one. Raises DfsError naming each block that
        could not be recovered; marks the rest verified."""
        singles = [b for b in blocks if b.pending_crc is not None]
        if not singles:
            return
        home = self.devices[0]

        def fetch() -> np.ndarray:
            stacked = torch.stack([b.pending_crc.view(torch.int32).to(home)
                                   for b in singles])
            return stacked.cpu().numpy().view(np.uint32)

        got = await asyncio.to_thread(fetch)
        bad = []
        for i, b in enumerate(singles):
            b.pending_crc = None
            b.verified = int(got[i]) == b.expected_crc
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

    # ---------------------------------------------------- warm infeed sweep

    async def read_meta_blocks_fast(
        self, meta: dict, device=None, verify: bool | str = "lazy",
    ) -> list[DeviceBlock]:
        """Steady-state fast path: CACHED file metadata (no master
        round-trip) and, where a block's replica is behind an already-probed
        local store, pread + upload in ONE worker-thread hop. Falls back to
        the general path per block. Returns lazy-verified DeviceBlocks;
        resolve with ``confirm``."""
        device = device or self.devices[0]

        async def fast_or_slow(block: dict) -> DeviceBlock:
            store = None
            if self.client.local_reads and not block.get("ec_data_shards"):
                for addr in block.get("locations") or []:
                    cached = self.client._local_stores.get(addr)
                    if cached and cached[0] is not None:
                        store = cached[0]
                        break
            device_verify = bool(verify) and bool(block.get("checksum_crc32c"))
            if store is None or not device_verify:
                return await self.read_block_to_device(block, device,
                                                       verify=verify)

            def fetch_put():
                data = store.read(block["block_id"])
                return host_to_device(bytes_to_words(data), device), len(data)

            try:
                words, size = await asyncio.to_thread(fetch_put)
                # _finish_block verifies tail blocks eagerly even under
                # "lazy"; its error must fall back too.
                db = await self._finish_block(block, words, size, verify)
            except Exception:
                logger.debug("local fast-path read of block %s failed; "
                             "retrying via general path",
                             block.get("block_id"), exc_info=True)
                return await self.read_block_to_device(block, device,
                                                       verify=verify)
            db.source = block
            db.device = device
            return db

        return list(await asyncio.gather(
            *(fast_or_slow(b) for b in meta["blocks"])
        ))

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


def device_array_to_bytes(arr: torch.Tensor, size: int) -> bytes:
    """Host copy-out (for tests / tools): unpad the device words."""
    return arr.contiguous().view(torch.uint8).reshape(-1)[:size].cpu() \
        .numpy().tobytes()
