"""Key → shard routing — the client's part of ``tpudfs/common/sharding.py``,
the port's own copy.

A sharded deployment runs a config server that hands out the ``ShardMap``
(``ConfigService/FetchShardMap``); each shard is a Raft group of masters.
The client only looks keys up and reads peers, so this copy holds the
lookups and :meth:`ShardMap.from_dict`, not the split, merge and
rebalance operations the config server runs.

- range strategy: sorted range-end keys; a key belongs to the first range
  whose end is >= the key;
- hash strategy: a CRC32 ring of virtual nodes.
"""

from __future__ import annotations

import bisect
import zlib
from dataclasses import dataclass, field

RANGE_MAX = "\U0010ffff"


def hash_key(key: str) -> int:
    """Deterministic CRC32 key hash."""
    return zlib.crc32(key.encode("utf-8")) & 0xFFFFFFFF


@dataclass
class ShardMap:
    strategy: str = "range"  # "range" | "hash"
    virtual_nodes: int = 16
    version: int = 0
    _range_ends: list[str] = field(default_factory=list)
    _range_ids: list[str] = field(default_factory=list)
    _ring: list[tuple[int, str]] = field(default_factory=list)
    _peers: dict[str, list[str]] = field(default_factory=dict)

    def has_shard(self, shard_id: str) -> bool:
        return shard_id in self._peers

    def get_peers(self, shard_id: str) -> list[str] | None:
        peers = self._peers.get(shard_id)
        return list(peers) if peers is not None else None

    def get_all_shards(self) -> list[str]:
        return sorted(self._peers)

    def get_all_masters(self) -> list[str]:
        seen: dict[str, None] = {}
        for peers in self._peers.values():
            for p in peers:
                seen[p] = None
        return list(seen)

    def ranges(self) -> list[tuple[str, str]]:
        """A range map's ``(end, shard)`` pairs in key order: each shard
        owns the keys above the previous end up to and including its
        own."""
        return list(zip(self._range_ends, self._range_ids))

    def get_shard(self, key: str) -> str | None:
        """The shard owning ``key``."""
        if self.strategy == "hash":
            if not self._ring:
                return None
            idx = bisect.bisect_left(self._ring, (hash_key(key), ""))
            if idx == len(self._ring):
                idx = 0
            return self._ring[idx][1]
        if not self._range_ends:
            return None
        idx = bisect.bisect_left(self._range_ends, key)
        if idx == len(self._range_ends):
            return None
        return self._range_ids[idx]

    @classmethod
    def from_dict(cls, d: dict) -> "ShardMap":
        """The map a config server ships (the reference's ``to_dict``)."""
        sm = cls(strategy=d.get("strategy", "range"),
                 virtual_nodes=d.get("virtual_nodes", 16),
                 version=d.get("version", 0))
        sm._range_ends = [e for e, _ in d.get("ranges", [])]
        sm._range_ids = [s for _, s in d.get("ranges", [])]
        sm._ring = [(int(h), s) for h, s in d.get("ring", [])]
        sm._peers = {k: list(v) for k, v in d.get("peers", {}).items()}
        return sm
