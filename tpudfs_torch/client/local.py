"""Short-circuit block reads from colocated chunkserver stores — the port of
the local half of ``tpudfs/client/client.py`` (``_local_store``,
``_read_local``, ``_read_block_range``, ``_read_ec_shards``).

A GPU host that runs chunkservers reads their blocks straight off its own
disk. :class:`LocalClient` is that reader with the metadata handed in: the
``metas`` dicts have the shape the master's ``GetFileInfo`` returns
(``{"path", "size", "blocks": [{"block_id", "size", "locations",
"checksum_crc32c", "ec_data_shards", "ec_parity_shards",
"original_size"}]}``). It exposes exactly the interface
:class:`tpudfs_torch.gpu.hbm_reader.HbmReader` duck-types, which the
reference ``tpudfs.client.Client`` exposes as well, and the range read
against cached metadata (``read_meta_range``) that the record and WebDataset
sources call.
"""

from __future__ import annotations

import asyncio
import logging

from tpudfs_torch.chunkserver.blockstore import BlockStore
from tpudfs_torch.common.erasure import decode as ec_decode

logger = logging.getLogger(__name__)


class DfsError(Exception):
    pass


class ChecksumMismatchError(DfsError):
    """Fetched data failed an integrity check (on-device CRC fold, or a
    shard shape that implies a truncated or corrupt local replica). Readers
    catch this type to decide whether a verified-path retry is worthwhile."""


def is_error_named(exc: BaseException, name: str) -> bool:
    """True when ``exc``'s class or one of its bases is called ``name``: the
    reference client raises its own error classes (``DfsError``,
    ``RpcError``), which the port must not import."""
    return any(c.__name__ == name for c in type(exc).__mro__)


def is_dfs_error(exc: BaseException) -> bool:
    """True for this module's DfsError and for any client's error class of
    that name."""
    return is_error_named(exc, "DfsError")


class LocalClient:
    """Reads blocks from local block stores only.

    ``stores``: ``{addr: (hot_dir, cold_dir_or_None)}``, one entry per
    colocated chunkserver; ``metas``: ``{path: file metadata}``."""

    local_reads = True

    def __init__(self, stores: dict, metas: dict | None = None):
        #: addr -> (BlockStore, retry_at), the reference client's layout.
        self._local_stores: dict[str, tuple[BlockStore | None, float | None]] = {
            addr: (BlockStore(hot, cold), None)
            for addr, (hot, cold) in stores.items()
        }
        self.metas = dict(metas or {})

    async def _local_store(self, addr: str) -> BlockStore | None:
        return self._local_stores.get(addr, (None, None))[0]

    async def get_file_info(self, path: str) -> dict | None:
        return self.metas.get(path)

    async def _read_local(self, addr: str, block_id: str, offset: int,
                          length: int, verify: bool = True, *, into=None):
        """One local replica read; None when the replica is absent or
        corrupt. ``verify=False`` skips the sidecar CRC pass — only for
        callers that verify the returned bytes end to end themselves."""
        store = await self._local_store(addr)
        if store is None:
            return None
        try:
            data = await asyncio.to_thread(
                store.read_verified if verify else store.read,
                block_id, offset, length or None, into=into,
            )
        except Exception as e:
            logger.debug("short-circuit read of %s via %s failed: %s",
                         block_id, addr, e)
            return None
        return data

    async def _read_block_range(self, block: dict, offset: int, length: int,
                                *, local_verify: bool = True, into=None):
        """First healthy local replica, in location order. ``into``:
        optional ``into(nbytes) -> writable buffer`` the bytes land in (the
        filled buffer is returned in place of ``bytes``)."""
        locations = [a for a in block["locations"] if a]
        if not locations:
            raise DfsError(f"no locations for block {block['block_id']}")
        for addr in locations:
            data = await self._read_local(addr, block["block_id"], offset,
                                          length, verify=local_verify,
                                          into=into)
            if data is not None:
                return data
        raise DfsError(
            f"all replicas failed for block {block['block_id']}: "
            f"no healthy local replica among {locations}"
        )

    async def _read_ec_shards(self, block: dict, *, local_verify: bool = True
                              ) -> list:
        """All k+m shard slots of an EC block; None per missing shard."""
        k = int(block["ec_data_shards"])
        m = int(block["ec_parity_shards"])
        locations = block["locations"]

        async def fetch(i: int):
            addr = locations[i] if i < len(locations) else ""
            if not addr:
                return None
            return await self._read_local(addr, block["block_id"], 0, 0,
                                          verify=local_verify)

        return list(await asyncio.gather(*(fetch(i) for i in range(k + m))))

    async def _read_ec_block(self, block: dict) -> bytes:
        """A whole EC block: the data shards joined when all are present,
        else the host RS decode from any k survivors."""
        k = int(block["ec_data_shards"])
        m = int(block["ec_parity_shards"])
        original = int(block.get("original_size") or block.get("size") or 0)
        shards = await self._read_ec_shards(block)
        try:
            return ec_decode(shards, k, m, original)
        except ValueError as e:
            raise DfsError(
                f"EC decode failed for block {block['block_id']}: {e}"
            ) from None

    async def read_meta_range(self, meta: dict, offset: int,
                              length: int) -> bytes:
        """``length`` bytes at ``offset`` of the file ``meta`` describes
        (the counterpart of the reference client's ``read_meta_range``):
        each touched replicated block read verified from its first healthy
        local replica, an EC block decoded whole and sliced. Clipped to the
        file's end; empty past it."""
        if offset >= meta["size"] or length <= 0:
            return b""
        length = min(length, meta["size"] - offset)
        parts = []
        pos = 0
        for block in meta["blocks"]:
            bstart, bend = pos, pos + int(block["size"])
            pos = bend
            lo, hi = max(offset, bstart), min(offset + length, bend)
            if lo >= hi:
                continue
            if block.get("ec_data_shards"):
                whole = self._read_ec_block(block)
                parts.append((whole, lo - bstart, hi - lo))
            else:
                parts.append((self._read_block_range(block, lo - bstart,
                                                     hi - lo), 0, None))
        got = await asyncio.gather(*(coro for coro, _o, _n in parts))
        return b"".join(data if n is None else data[o:o + n]
                        for data, (_c, o, n) in zip(got, parts))
