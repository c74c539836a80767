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
reference ``tpudfs.client.Client`` exposes as well.
"""

from __future__ import annotations

import asyncio
import logging

from tpudfs_torch.chunkserver.blockstore import BlockStore

logger = logging.getLogger(__name__)


class DfsError(Exception):
    pass


class ChecksumMismatchError(DfsError):
    """Fetched data failed an integrity check (on-device CRC fold, or a
    shard shape that implies a truncated or corrupt local replica). Readers
    catch this type to decide whether a verified-path retry is worthwhile."""


def is_dfs_error(exc: BaseException) -> bool:
    """True for this module's DfsError and for any client's error class of
    that name (the reference client raises its own ``DfsError``; the port
    must not import it)."""
    return any(c.__name__ == "DfsError" for c in type(exc).__mro__)


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
