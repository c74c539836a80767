"""The bytes of the cells' device work, from the shapes of the work alone
(never from what an implementation happens to move), and the peaks they
are held against (``peaks.json``).

A roofline share is the least time the card could take, the bytes over
its peak bandwidth, divided by the device time the named kernels took.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peak(device_kind: str, key: str) -> float | None:
    """A published peak of the card named ``device_kind`` (as
    ``torch.cuda.get_device_name`` gives it); None for a card the table
    lacks."""
    return json.loads(PEAKS.read_text()).get(device_kind, {}).get(key)


def verify_bytes(block_sizes: list[int]) -> int:
    """Checking a block's CRC32C reads each of its bytes once."""
    return sum(block_sizes)


def rebuild_bytes(block_sizes: list[int], k: int, lost: tuple) -> int:
    """Rebuilding an RS(k, m) block whose shards ``lost`` are gone reads k
    surviving shards and writes the data shards that are lost; a shard is
    ceil(size / k) bytes. Lost parity shards need no rebuild for a read."""
    lost_data = sum(1 for j in lost if j < k)
    return sum((k + lost_data) * -(-size // k) for size in block_sizes
               if lost_data)


def share(nbytes: float, seconds: float, bytes_per_s: float | None
          ) -> float | None:
    """Percent of the roofline: (bytes / peak) / seconds. None where
    nothing was timed or the card's peak is not known."""
    if not seconds or not bytes_per_s or not nbytes:
        return None
    return nbytes / bytes_per_s / seconds * 100.0
