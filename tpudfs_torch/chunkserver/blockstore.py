"""On-disk block store: the chunkserver's format, byte for byte — the port's
own copy of the Python paths of ``tpudfs/chunkserver/blockstore.py``.

- A block is a flat file named by its block id, with a ``.meta`` sidecar:
  a ``<4sHHII`` header (magic ``TPUM``, version 1, reserved, chunk size,
  count) followed by one little-endian uint32 CRC32C per 512-byte chunk.
- Writes go through temp file + fsync + rename, data then sidecar.
- A block lives in the hot dir or, after tiering, the cold dir; lookups
  check hot first.

A colocated reader (the short-circuit read of ``client.local``) opens the
chunkserver's directories with this class. Reads can land straight in a
caller's buffer (``into``), so a block's bytes are copied once, from the
page cache into the chunk grid that goes to the device.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c_chunks

_META_MAGIC = b"TPUM"
_META_VERSION = 1
_META_HEADER = struct.Struct("<4sHHII")  # magic, version, reserved, chunk_size, count


class BlockCorruptionError(Exception):
    """Stored data does not match its checksum sidecar."""


class BlockNotFoundError(FileNotFoundError):
    pass


def _check_block_id(block_id: str) -> None:
    if not block_id or "/" in block_id or "\x00" in block_id or block_id.startswith("."):
        raise ValueError(f"invalid block id: {block_id!r}")


def write_durable(path: str | Path, data) -> None:
    """Atomic durable publish: write ``<path>.tmp`` (looping over short
    writes), fsync, rename."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        view = memoryview(data).cast("B")
        while view:
            n = os.write(fd, view)
            view = view[n:]
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


class BlockStore:
    def __init__(self, hot_dir: str | Path, cold_dir: str | Path | None = None,
                 chunk_size: int = CHECKSUM_CHUNK_SIZE):
        self.hot_dir = Path(hot_dir)
        self.cold_dir = Path(cold_dir) if cold_dir else None
        self._hot_str = str(self.hot_dir)
        self.chunk_size = chunk_size
        self.hot_dir.mkdir(parents=True, exist_ok=True)
        if self.cold_dir:
            self.cold_dir.mkdir(parents=True, exist_ok=True)

    # -- paths --------------------------------------------------------------

    def block_path(self, block_id: str) -> Path:
        """Hot path if present there, else cold."""
        _check_block_id(block_id)
        hot = self.hot_dir / block_id
        if hot.exists() or self.cold_dir is None:
            return hot
        cold = self.cold_dir / block_id
        return cold if cold.exists() else hot

    def hot_path_str(self, block_id: str) -> str:
        """Hot-tier data path as a plain string, with no existence probe."""
        _check_block_id(block_id)
        return f"{self._hot_str}/{block_id}"

    def _meta_path(self, data_path: Path) -> Path:
        return data_path.with_name(data_path.name + ".meta")

    # -- write --------------------------------------------------------------

    def write(self, block_id: str, data, checksums: np.ndarray | None = None
              ) -> np.ndarray:
        """Store block + sidecar durably; returns the per-chunk CRCs.

        ``checksums``: per-chunk CRCs the caller already holds for ``data``
        (one layout written to several replicas CRCs the bytes once)."""
        _check_block_id(block_id)
        path = self.hot_dir / block_id
        if checksums is None:
            checksums = crc32c_chunks(data, self.chunk_size)
        write_durable(path, data)
        write_durable(self._meta_path(path), self._encode_meta(checksums))
        return checksums

    def _encode_meta(self, checksums: np.ndarray) -> bytes:
        header = _META_HEADER.pack(
            _META_MAGIC, _META_VERSION, 0, self.chunk_size, len(checksums)
        )
        return header + np.asarray(checksums, dtype="<u4").tobytes()

    def read_meta(self, block_id: str) -> np.ndarray:
        path = self._meta_path(self.block_path(block_id))
        try:
            raw = path.read_bytes()
        except FileNotFoundError:
            raise BlockNotFoundError(f"no sidecar for block {block_id}") from None
        try:
            magic, version, _, chunk_size, count = _META_HEADER.unpack_from(raw)
            sums = np.frombuffer(raw, dtype="<u4", offset=_META_HEADER.size)
        except (struct.error, ValueError) as e:
            raise BlockCorruptionError(
                f"unreadable sidecar for block {block_id}: {e}"
            ) from None
        if magic != _META_MAGIC or version != _META_VERSION:
            raise BlockCorruptionError(f"bad sidecar header for block {block_id}")
        if chunk_size != self.chunk_size:
            raise BlockCorruptionError(
                f"sidecar chunk size {chunk_size} != store chunk size {self.chunk_size}"
            )
        if len(sums) != count:
            raise BlockCorruptionError(f"truncated sidecar for block {block_id}")
        return sums.astype(np.uint32)

    # -- read ---------------------------------------------------------------

    def size(self, block_id: str) -> int:
        try:
            return self.block_path(block_id).stat().st_size
        except FileNotFoundError:
            raise BlockNotFoundError(f"block {block_id} not found") from None

    def read(self, block_id: str, offset: int = 0, length: int | None = None,
             *, into=None):
        """Raw pread. ``into``: optional ``into(nbytes) -> writable buffer``
        factory; the bytes are read straight into that buffer, which is
        returned in place of ``bytes``."""
        path = self.block_path(block_id)
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError:
            raise BlockNotFoundError(f"block {block_id} not found") from None
        try:
            total = os.fstat(fd).st_size
            if length is None:
                length = max(total - offset, 0)
            if into is None:
                return os.pread(fd, length, offset)
            length = max(min(length, total - offset), 0)
            sink = into(length)
            view = memoryview(sink).cast("B")
            done = 0
            while done < length:
                n = os.preadv(fd, [view[done:]], offset + done)
                if n <= 0:
                    raise BlockCorruptionError(
                        f"block {block_id}: short read at {offset + done}"
                    )
                done += n
            return sink
        finally:
            os.close(fd)

    def read_verified(self, block_id: str, offset: int = 0,
                      length: int | None = None, *, into=None):
        """pread + verify of exactly the chunks the range touches. A
        whole-block read is checked on the bytes it returns; a partial
        range re-reads its chunk span (it may end mid-chunk)."""
        data = self.read(block_id, offset, length, into=into)
        if not len(data):
            return data
        if offset == 0 and len(data) == self.size(block_id):
            expected = self.read_meta(block_id)
            actual = crc32c_chunks(data, self.chunk_size)
            if len(actual) != len(expected) or \
                    not np.array_equal(actual, expected):
                raise BlockCorruptionError(
                    f"block {block_id}: corrupt chunk in verified read"
                )
        else:
            self.verify_range(block_id, offset, len(data))
        return data

    def verify_range(self, block_id: str, offset: int, length: int) -> None:
        """Verify only the chunks overlapped by [offset, offset+length)."""
        if length <= 0:
            return
        expected = self.read_meta(block_id)
        first = offset // self.chunk_size
        last = (offset + length - 1) // self.chunk_size
        if last >= len(expected):
            raise BlockCorruptionError(
                f"block {block_id}: range beyond sidecar ({last} >= {len(expected)})"
            )
        span = self.read(block_id, first * self.chunk_size,
                         (last - first + 1) * self.chunk_size)
        actual = crc32c_chunks(span, self.chunk_size)
        want = expected[first : last + 1]
        if len(actual) != len(want) or not np.array_equal(actual, want):
            raise BlockCorruptionError(
                f"block {block_id}: corrupt chunk in range [{first},{last}]"
            )
