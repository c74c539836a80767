"""WebDataset-style sharded-tar datasets on DFS — port of
``tpudfs/tpu/wds.py``.

Samples are packed as consecutive members of plain tar files ("shards"):
one sample is all members sharing a basename key (``000042.img``,
``000042.cls`` → sample ``000042``), and shards are ordinary DFS files.

- :func:`write_wds_shards` packs an iterable of samples into fixed-budget
  tar shards and writes them through a DFS client (duck-typed: anything
  with ``create_file``); pure ``tarfile``, byte-identical to the
  reference's writer.
- :class:`DfsWdsSource` — a map-style source over those shards: one index
  pass per shard walks the tar headers with spanned range reads
  (``read_meta_range``, no metadata round-trip per member), then
  ``__getitem__`` fetches exactly one sample's members with one range read.

Pickling: as :class:`~tpudfs_torch.gpu.record_source.DfsRecordSource`, the
client is rebuilt lazily per process from the picklable ``client_factory``.
"""

from __future__ import annotations

import asyncio
import io
import tarfile
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from tpudfs_torch.gpu.record_source import DfsSourceBase

_TAR_BLOCK = 512
#: tar typeflags for regular files (classic \0 and '0').
_REG_TYPES = (b"0", b"\x00")


async def write_wds_shards(
    client,
    prefix: str,
    samples: Iterable[dict[str, bytes]],
    *,
    shard_size_bytes: int = 8 << 20,
    ec: tuple[int, int] | None = None,
) -> list[str]:
    """Pack ``samples`` into tar shards under ``prefix-%06d.tar``.

    Each sample is ``{"__key__": str, <ext>: bytes, ...}``; members are
    written as ``<key>.<ext>`` in sample order (the WebDataset contract).
    A shard closes once its payload crosses ``shard_size_bytes``. Returns
    the DFS paths written.
    """
    paths: list[str] = []
    buf = io.BytesIO()
    tf = tarfile.open(fileobj=buf, mode="w")

    async def flush() -> None:
        nonlocal buf, tf
        tf.close()
        data = buf.getvalue()
        # Rebind in two steps: the new tarfile must wrap the NEW buffer
        # (a tuple RHS would evaluate fileobj=buf against the old one).
        buf = io.BytesIO()
        tf = tarfile.open(fileobj=buf, mode="w")
        if len(data) <= tarfile.RECORDSIZE and not any(data):
            return  # only the zero trailer: nothing to write
        path = f"{prefix}-{len(paths):06d}.tar"
        await client.create_file(path, data, ec=ec)
        paths.append(path)

    for sample in samples:
        key = sample["__key__"]
        # USTAR-only discipline: the indexer walks raw 512 B headers, so
        # PAX/GNU extension records (emitted for long or non-ASCII names)
        # would corrupt sample boundaries. WebDataset keys are dot-free by
        # contract (everything after the FIRST dot is the extension).
        if "." in key:
            raise ValueError(f"WDS keys must not contain '.': {key!r}")
        for ext, payload in sample.items():
            if ext == "__key__":
                continue
            name = f"{key}.{ext}"
            if len(name) > 100 or not name.isascii():
                raise ValueError(
                    f"member name {name!r} exceeds USTAR limits "
                    "(<=100 ASCII chars)"
                )
            info = tarfile.TarInfo(name=name)
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
        if buf.tell() >= shard_size_bytes:
            await flush()
    await flush()
    return paths


class DfsWdsSource(DfsSourceBase):
    """Map-style source over WebDataset tar shards in DFS.

    ``__getitem__(i)`` returns ``{"__key__": key, <ext>: bytes, ...}`` for
    sample ``i`` in global (shard-major, in-tar) order.
    """

    def __init__(self, client_factory: Callable[[], Any],
                 shards: Sequence[str]):
        super().__init__(client_factory)
        self.shards = list(shards)
        self._metas: dict[str, dict] = {}
        #: per sample: (key, [(ext, shard_path, data_off, size), ...])
        self._samples: list[tuple[str, list[tuple[str, str, int, int]]]] = []
        try:
            self._build_index()
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------ indexing

    def _build_index(self) -> None:
        cl = self._client_loop()
        for path, meta in zip(self.shards, self._fetch_metas(self.shards)):
            self._metas[path] = meta

        async def index_all(client) -> list[list]:
            # Shards index independently and concurrently; results are
            # appended in shard order (shard-major sample order).
            return list(await asyncio.gather(*(
                self._index_shard(client, path, self._metas[path])
                for path in self.shards
            )))

        for shard_samples in cl.run(index_all(cl.client)):
            self._samples.extend(shard_samples)

    #: readahead window for the tar-header walk: small members mean many
    #: headers per span (one range read covers dozens of samples).
    INDEX_SPAN = 512 * 1024

    async def _index_shard(self, client, path: str,
                           meta: dict) -> list:
        """Walk the tar member headers with spanned readahead — header
        offsets are computable without touching member data, so a shard of
        small samples indexes in O(size / INDEX_SPAN) range reads."""
        size = int(meta["size"])
        span_start = 0
        span = b""

        async def header_at(off: int) -> bytes:
            nonlocal span_start, span
            if off < span_start or off + _TAR_BLOCK > span_start + len(span):
                span_start = off
                span = await client.read_meta_range(
                    meta, off, min(self.INDEX_SPAN, size - off)
                )
            rel = off - span_start
            return span[rel:rel + _TAR_BLOCK]

        off = 0
        members: dict[str, list[tuple[str, str, int, int]]] = {}
        order: list[str] = []
        while off + _TAR_BLOCK <= size:
            header = await header_at(off)
            if len(header) < _TAR_BLOCK or header.count(b"\0") == _TAR_BLOCK:
                break  # tar end-of-archive marker
            try:
                info = tarfile.TarInfo.frombuf(header, "utf-8", "surrogateescape")
            except tarfile.TarError as e:
                raise ValueError(f"{path}: bad tar header at {off}: {e}") \
                    from None
            data_off = off + _TAR_BLOCK
            name = info.name
            if info.type in _REG_TYPES and not name.endswith("/"):
                # WebDataset contract: key = basename up to the FIRST dot,
                # extension = everything after (multi-part exts like
                # "seg.png" stay whole). Non-regular entries (PAX/GNU
                # metadata, directories) are skipped — write_wds_shards
                # never emits them, but foreign tars may.
                if "." in name:
                    key, ext = name.split(".", 1)
                else:
                    key, ext = name, "bin"
                if key not in members:
                    members[key] = []
                    order.append(key)
                members[key].append((ext, path, data_off, info.size))
            off = data_off + -(-info.size // _TAR_BLOCK) * _TAR_BLOCK
        return [(key, members[key]) for key in order]

    # -------------------------------------------------------------- protocol

    def __len__(self) -> int:
        return len(self._samples)

    def __getitem__(self, i: int) -> dict[str, Any]:
        key, members = self._samples[i]
        cl = self._client_loop()
        # A sample's members are CONSECUTIVE tar entries of one shard
        # (write_wds_shards never splits a sample), so one contiguous
        # range read covers them all; slice locally.
        path = members[0][1]
        lo = min(off for _e, _p, off, _s in members)
        hi = max(off + size for _e, _p, off, size in members)
        blob = cl.run(
            cl.client.read_meta_range(self._metas[path], lo, hi - lo)
        )
        out: dict[str, Any] = {"__key__": key}
        for ext, _path, off, size in members:
            out[ext] = blob[off - lo : off - lo + size]
        return out

    def __repr__(self) -> str:
        return (f"DfsWdsSource(shards={len(self.shards)}, "
                f"samples={len(self._samples)})")


def decode_sample(sample: dict, *, image_ext: str = "img",
                  label_ext: str = "cls", image_shape=None,
                  dtype: str = "float32") -> tuple[np.ndarray, np.int32]:
    """The standard WDS decode step for raw-array datasets: bytes -> (x, y).
    Use as a per-sample transform (a ``DataLoader`` ``collate_fn``'s
    first step, or a map over the source)."""
    x = np.frombuffer(sample[image_ext], dtype=dtype)
    if image_shape is not None:
        x = x.reshape(image_shape)
    y = np.int32(int(sample[label_ext].decode()))
    return x, y
