"""Sharded checkpoints over tpudfs with a verified restore into device
memory — port of ``tpudfs/tpu/checkpoint.py``.

A data-parallel training job checkpoints every N steps; each replica owns
one shard of the weight/optimizer state (ZeRO-style partitioning) and writes
only that shard. The contract, as in the reference:

- **All-or-nothing visibility.** Shard payloads land under a per-step
  staging prefix (``{base}/.ckpt/{step}/``, :mod:`tpudfs_torch.common.ckptpaths`);
  the checkpoint becomes visible through one atomic master command,
  ``publish_checkpoint``, which renames the staged manifest to
  ``{base}/MANIFEST-{step}``. Readers list manifests only.
- **Resumable, idempotent saves.** A shard whose file already carries the
  payload's content ETag (``ckpt-{crc32c:08x}-{size}``) is skipped on
  re-save; a replayed commit converges through the master's idempotent
  publish, and an older step is fenced by the master.
- **Gracefully degrading restore.** Per shard: the hot 3x-replicated copy
  (replica failover inside the read path) → the erasure-coded cold copy
  (RS reconstruction) → :class:`DegradedRestoreError`, CRC-verified end to
  end against the manifest on every path.

The device restore (:func:`restore_shard_device`) reads the shard's blocks
through :class:`~tpudfs_torch.gpu.hbm_reader.HbmReader` with eager
verification: every full block is one launch of the fused CRC32C kernel
(``crc32c_blocks``), an unaligned tail block is checked through the
per-chunk kernel (``crc32c_chunks``), and a degraded EC block is rebuilt on
the device by the GF(2^8) kernel (``gf256_matmul``) before its check. The
whole-shard CRC is reconciled from the per-block checksums by the GF(2)
combine, with no byte pass. Tensors are views of the concatenated word
stream (4-byte dtypes) or bounce through the host with a per-tensor CRC.

Payload format (byte-identical to the reference's): tensors sorted by
name, each raw C-order at a 512-byte-aligned offset; the per-shard spec
records name/dtype/shape/offset/size/crc32c per tensor plus the
whole-payload CRC.

Deliberate differences from the reference:

- The client is duck-typed (the reference ``tpudfs.client.Client``, or any
  object with its namespace and read methods); errors are matched by class
  name (``client/local.py::is_error_named``).
- Deadline and tenant scopes come from ``scopes=``: any object with
  ``deadline_scope``, ``tenant_scope``, ``shielded_from_deadline`` and
  ``as_system_tenant`` (the reference's ``tpudfs.common.resilience`` module
  is one). The default, :class:`NoScopes`, installs none.
- ``restore(..., device=...)`` without a ``reader`` raises ``ValueError``
  (the reference quietly returns host arrays); ``device=None`` returns
  host numpy arrays, as the reference does.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import logging
import time

import numpy as np
import torch

from tpudfs_torch.client.local import (
    ChecksumMismatchError,
    DfsError,
    is_dfs_error,
    is_error_named,
)
from tpudfs_torch.common import ckptpaths
from tpudfs_torch.common.checksum import crc32c, crc32c_combine
from tpudfs_torch.gpu import resolve_device
from tpudfs_torch.gpu.hbm_reader import device_array_to_bytes

logger = logging.getLogger(__name__)

FORMAT = "tpudfs-ckpt-1"
#: Tensor alignment inside a shard payload: the 512-byte CRC chunk size.
#: Keeps every tensor offset chunk-aligned (device CRC granularity) and
#: word-aligned (the device restore slices a 32-bit word stream).
_ALIGN = 512

#: Errors (by class name, any client's) a shard read can die with before
#: its fallback is consulted; ``asyncio.TimeoutError`` and ``OSError`` too.
_READ_ERROR_NAMES = ("DfsError", "ChecksumMismatchError", "BudgetExhausted")

#: numpy dtype strings (``np.dtype(...).str``) of the payload format and
#: the torch dtype each restores into.
TORCH_DTYPES = {
    "<f4": torch.float32, "<i4": torch.int32, "<u4": torch.uint32,
    "|i1": torch.int8, "|u1": torch.uint8, "|b1": torch.bool,
    "<i8": torch.int64, "<u8": torch.uint64, "<f8": torch.float64,
    "<f2": torch.float16, "<i2": torch.int16, "<u2": torch.uint16,
}


def torch_dtype(dtype: str) -> torch.dtype:
    """The torch dtype of a payload dtype string; raises on any other."""
    try:
        return TORCH_DTYPES[dtype]
    except KeyError:
        raise ValueError(f"no torch dtype for payload dtype {dtype!r}") \
            from None


def _is_read_error(exc: BaseException) -> bool:
    return isinstance(exc, (asyncio.TimeoutError, OSError)) or any(
        is_error_named(exc, name) for name in _READ_ERROR_NAMES)


class CheckpointError(DfsError):
    """Base for checkpoint-layer failures."""


class CheckpointNotFoundError(CheckpointError):
    """No published manifest matches the requested step (or none exist)."""


class IncompleteCheckpointError(CheckpointError):
    """Commit refused: some shard is missing or not durably complete."""


class DegradedRestoreError(CheckpointError):
    """A shard is unreadable through the hot copy AND the EC cold copy."""


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


@dataclasses.dataclass
class TensorSpec:
    """One tensor's placement inside a shard payload."""

    name: str
    dtype: str  # numpy dtype .str, e.g. "<f4"
    shape: tuple[int, ...]
    offset: int
    size: int
    crc32c: int

    def to_dict(self) -> dict:
        d = self.__dict__.copy()
        d["shape"] = list(self.shape)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TensorSpec":
        d = dict(d)
        d["shape"] = tuple(d["shape"])
        return cls(**d)


def _as_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def pack_shard(tree: dict) -> tuple[bytes, list[TensorSpec]]:
    """Serialize a flat ``{name: array}`` tree (numpy arrays or torch
    tensors) into one payload.

    Deterministic: tensors in sorted name order at aligned offsets, so the
    same tree always produces byte-identical payloads — which is what makes
    the content-ETag resume probe sound."""
    buf = bytearray()
    specs: list[TensorSpec] = []
    for name in sorted(tree):
        arr = _as_numpy(tree[name])
        raw = arr.tobytes()
        offset = _align(len(buf))
        buf.extend(b"\x00" * (offset - len(buf)))
        specs.append(TensorSpec(name=name, dtype=arr.dtype.str,
                                shape=tuple(arr.shape), offset=offset,
                                size=len(raw), crc32c=crc32c(raw)))
        buf.extend(raw)
    return bytes(buf), specs


def unpack_shard(payload: bytes, tensors: list[dict]) -> dict:
    """Payload bytes → ``{name: np.ndarray}``, CRC-verifying every tensor
    (a bug in offset bookkeeping surfaces as a checksum error, not silently
    sheared weights)."""
    out: dict[str, np.ndarray] = {}
    for t in tensors:
        spec = TensorSpec.from_dict(t) if isinstance(t, dict) else t
        raw = payload[spec.offset:spec.offset + spec.size]
        if len(raw) != spec.size or crc32c(raw) != spec.crc32c:
            raise ChecksumMismatchError(
                f"tensor {spec.name!r} failed CRC inside its shard payload"
            )
        out[spec.name] = np.frombuffer(raw, dtype=np.dtype(spec.dtype)) \
            .reshape(spec.shape)
    return out


def _validate_manifest(body: bytes) -> dict:
    """Parse + structurally validate a manifest body (the bytes themselves
    arrive through the client's CRC-verified read path)."""
    manifest = json.loads(body)
    if manifest.get("format") != FORMAT:
        raise CheckpointError(
            f"unknown checkpoint format {manifest.get('format')!r}")
    for key in ("base", "step", "num_shards", "shards"):
        if key not in manifest:
            raise CheckpointError(f"manifest missing required key {key!r}")
    if len(manifest["shards"]) != int(manifest["num_shards"]):
        raise CheckpointError(
            f"manifest lists {len(manifest['shards'])} shard specs for "
            f"num_shards={manifest['num_shards']}")
    return manifest


class NoScopes:
    """The default ``scopes=``: no deadline, tenant or shield context."""

    @staticmethod
    def deadline_scope(budget):
        return contextlib.nullcontext()

    @staticmethod
    def tenant_scope(tenant):
        return contextlib.nullcontext()

    @staticmethod
    def shielded_from_deadline():
        return contextlib.nullcontext()

    @staticmethod
    def as_system_tenant():
        return contextlib.nullcontext()


# ------------------------------------------------------------ device restore


def _add(stage_s: dict | None, key: str, seconds: float) -> None:
    if stage_s is not None:
        stage_s[key] = stage_s.get(key, 0.0) + seconds


async def restore_shard_device(reader, client, spec: dict, device,
                               stats: dict, *,
                               stage_s: dict | None = None) -> dict:
    """One shard's tensors on ``device``, verified on the device.

    Blocks land through ``reader.read_file_to_device_blocks(path,
    verify=True)`` (each checked on arrival; a corrupt replica is re-read
    through the host-verified path), the whole-shard CRC is reconciled from
    the master-recorded block checksums, and the shard falls back from the
    hot copy to the EC cold copy (``stats["degraded_shard_reads"]`` counts
    it) before :class:`DegradedRestoreError`. 4-byte tensors are views of
    the concatenated word stream; every other dtype bounces through the
    host with its own CRC check.

    ``stage_s`` (optional) accumulates wall seconds: ``read`` (blocks into
    device memory, verified; failed attempts included), ``combined_crc``,
    ``assemble`` (concatenation and views) and ``bounce``."""
    device = resolve_device(device)
    clock = time.perf_counter
    sources = [p for p in (spec.get("path"), spec.get("ec_path"))
               if p is not None]
    blocks = None
    last: Exception | None = None
    for i, path in enumerate(sources):
        if i > 0:
            stats["degraded_shard_reads"] += 1
            logger.warning(
                "shard %s: hot copy unreadable in the device path (%s); "
                "reconstructing from EC cold copy %s",
                spec["shard"], last, path)
        t0 = clock()
        try:
            blocks = await reader.read_file_to_device_blocks(path, verify=True)
            t1 = clock()
            _add(stage_s, "read", t1 - t0)
            await _check_combined_crc(client, path, spec)
            _add(stage_s, "combined_crc", clock() - t1)
            break
        except Exception as e:
            if not _is_read_error(e):
                raise
            _add(stage_s, "read", clock() - t0)
            blocks, last = None, e
    if blocks is None:
        raise DegradedRestoreError(
            f"shard {spec['shard']} unrestorable into device memory: every "
            f"copy failed ({last})")
    if any(b.size % _ALIGN for b in blocks[:-1]):
        # The word stream is sliced by payload offset, which is only sound
        # when every block but the last is whole 512-byte chunks.
        raise ValueError(
            f"shard {spec['shard']}: block sizes must be multiples of "
            f"{_ALIGN} for a device restore")
    t0 = clock()
    flat = [b.array.view(torch.int32).reshape(-1).to(device) for b in blocks]
    words = flat[0] if len(flat) == 1 else torch.cat(flat)
    out: dict[str, torch.Tensor] = {}
    bounce = []
    for t in spec["tensors"]:
        dt = torch_dtype(t["dtype"])
        lo = t["offset"] // 4
        if dt.itemsize == 4 and t["size"] % 4 == 0:
            out[t["name"]] = words[lo:lo + t["size"] // 4].view(dt) \
                .reshape(t["shape"])
        else:
            bounce.append(t)
    t1 = clock()
    _add(stage_s, "assemble", t1 - t0)
    for t in bounce:
        # Not a whole number of 32-bit words: through the host (rare —
        # training state is overwhelmingly 4-byte).
        lo = t["offset"] // 4
        raw = device_array_to_bytes(words[lo:lo + _align(t["size"]) // 4],
                                    t["size"])
        if crc32c(raw) != t["crc32c"]:
            raise ChecksumMismatchError(
                f"tensor {t['name']!r} failed CRC on host bounce")
        arr = np.frombuffer(bytearray(raw), dtype=np.dtype(t["dtype"]))
        out[t["name"]] = torch.from_numpy(arr).reshape(t["shape"]).to(device)
    _add(stage_s, "bounce", clock() - t1)
    return {t["name"]: out[t["name"]] for t in spec["tensors"]}


async def _check_combined_crc(client, path: str, spec: dict) -> None:
    """Whole-shard CRC from the master-recorded per-block checksums via
    ``crc32c_combine`` — metadata math only, no byte reread. Applies when
    the block metadata reconciles to the payload length (the hot copy
    always does; EC block records may carry coded sizes)."""
    meta = await client.get_file_info(path)
    if meta is None:
        raise DfsError(f"file not found: {path}")
    crc, total = 0, 0
    for b in meta.get("blocks", []):
        size = int(b.get("original_size") or b.get("size") or 0)
        if not size or not b.get("checksum_crc32c"):
            return  # pre-checksum metadata: per-block verify covers it
        crc = crc32c_combine(crc, int(b["checksum_crc32c"]), size)
        total += size
    if total != spec["size"]:
        return  # coded sizes don't reconcile; per-block verify covers it
    if crc != spec["crc32c"]:
        raise ChecksumMismatchError(
            f"{path}: combined block CRCs disagree with the manifest "
            "whole-shard CRC")


# ------------------------------------------------------------------ manager


class CheckpointManager:
    """Save/commit/restore partitioned checkpoints under ``base``.

    ``ec=(k, m)`` shapes the cold copy (RS(k, m); None disables it);
    ``hot_copies=False`` drops the replicated hot copy and saves the EC
    copy only. ``reader`` is an optional
    :class:`~tpudfs_torch.gpu.hbm_reader.HbmReader`, required when
    ``restore(..., device=...)`` asks for tensors in device memory.

    Budgets: ``save_budget_s``/``restore_budget_s`` install a deadline
    scope around each public op through ``scopes`` (an outer scope of the
    training loop wins when the scopes implement that, as the reference's
    do)."""

    def __init__(self, client, base: str, *, num_shards: int,
                 ec: tuple[int, int] | None = (3, 2), hot_copies: bool = True,
                 reader=None, save_budget_s: float | None = None,
                 restore_budget_s: float | None = None,
                 tenant: str | None = None, scopes=NoScopes):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if not hot_copies and not ec:
            raise ValueError("need hot copies, an EC shape, or both")
        self.client = client
        self.base = base.rstrip("/")
        self.num_shards = num_shards
        self.ec = tuple(ec) if ec else None
        self.hot_copies = hot_copies
        block_size = getattr(client, "block_size", None)
        if reader is not None and block_size is not None \
                and block_size % _ALIGN:
            raise ValueError(
                f"block_size {block_size} must be a multiple of "
                f"{_ALIGN} for device restore")
        self.reader = reader
        self.save_budget_s = save_budget_s
        self.restore_budget_s = restore_budget_s
        #: Tenant identity stamped on save/restore RPCs; staging GC always
        #: runs as the system tenant.
        self.tenant = tenant
        self.scopes = scopes
        self.stats = {
            "shards_written": 0,    # payload puts that hit the wire
            "shards_skipped": 0,    # resume probe proved the shard durable
            "commits": 0,
            "already_published": 0,  # idempotent re-publish converged
            "restored_shards": 0,
            "degraded_shard_reads": 0,  # hot copy dead -> EC cold copy
            "gc_deleted": 0,
        }

    @contextlib.contextmanager
    def _op_scope(self, budget: float | None):
        """Deadline + tenant scope for one public op."""
        with self.scopes.deadline_scope(budget), \
                self.scopes.tenant_scope(self.tenant):
            yield

    # ------------------------------------------------------------------ save

    @staticmethod
    def _content_etag(crc: int, size: int) -> str:
        """Content ETag stored on every checkpoint file: the resume probe
        compares it (plus size) against a re-packed payload."""
        return f"ckpt-{crc:08x}-{size}"

    async def save_shard(self, step: int, shard: int, tree: dict) -> dict:
        """Durably write one shard's payload (hot + EC copies) and its
        spec. Idempotent: a payload already durable under the same content
        ETag is skipped. Returns the shard spec dict."""
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard {shard} out of range")
        payload, tensors = pack_shard(tree)
        crc = crc32c(payload)
        etag = self._content_etag(crc, len(payload))
        attrs = {"ckpt_step": str(step), "ckpt_shard": str(shard),
                 "ckpt_crc32c": f"{crc:08x}"}
        data_path = ckptpaths.shard_data_path(self.base, step, shard) \
            if self.hot_copies else None
        ec_path = ckptpaths.shard_ec_path(self.base, step, shard) \
            if self.ec else None
        with self._op_scope(self.save_budget_s):
            if data_path is not None:
                await self._put_if_absent(data_path, payload, etag, attrs,
                                          ec=None)
            if ec_path is not None:
                await self._put_if_absent(ec_path, payload, etag, attrs,
                                          ec=self.ec)
            spec = {
                "shard": shard, "path": data_path, "ec_path": ec_path,
                "size": len(payload), "crc32c": crc, "etag": etag,
                "tensors": [t.to_dict() for t in tensors],
            }
            body = json.dumps(spec, sort_keys=True).encode()
            await self.client.create_file(
                ckptpaths.shard_spec_path(self.base, step, shard), body,
                overwrite=True)
        return spec

    async def _put_if_absent(self, path: str, payload: bytes, etag: str,
                             attrs: dict, ec: tuple[int, int] | None) -> None:
        """Probe, then put only when the durable state doesn't already
        match; ``overwrite=True`` replaces a half-written victim of an
        earlier crash."""
        info = await self.client.get_file_info(path)
        if info is not None and info.get("etag_md5") == etag \
                and int(info.get("size", -1)) == len(payload):
            self.stats["shards_skipped"] += 1
            return
        await self.client.create_file(path, payload, ec=ec, etag=etag,
                                      overwrite=True, attrs=attrs)
        self.stats["shards_written"] += 1

    async def commit(self, step: int) -> dict:
        """Phase two: verify every shard is durable (:meth:`_verify_staged`),
        stage the manifest, then publish it atomically."""
        with self._op_scope(self.save_budget_s):
            shards = await self._verify_staged(step)
            manifest = {
                "format": FORMAT, "base": self.base, "step": step,
                "num_shards": self.num_shards,
                "ec": list(self.ec) if self.ec else None,
                "created_at_ms": int(time.time() * 1000),
                "shards": shards,
            }
            body = json.dumps(manifest, sort_keys=True).encode()
            staged = ckptpaths.staged_manifest_path(self.base, step)
            await self.client.create_file(staged, body, overwrite=True)
            fresh = await self.client.publish_checkpoint(
                self.base, step, src=staged,
                dst=ckptpaths.manifest_path(self.base, step))
            self.stats["commits"] += 1
            if not fresh:
                self.stats["already_published"] += 1
        return manifest

    async def _verify_staged(self, step: int) -> list[dict]:
        """Every shard's spec present + payload files durably complete
        with matching size/ETag; raises :class:`IncompleteCheckpointError`
        naming what is missing."""
        async def one(shard: int) -> dict:
            spec_path = ckptpaths.shard_spec_path(self.base, step, shard)
            try:
                spec = json.loads(await self.client.get_file(spec_path))
            except Exception as e:
                if not is_dfs_error(e):
                    raise
                raise IncompleteCheckpointError(
                    f"step {step} shard {shard}: spec missing ({e})"
                ) from e
            for path in (spec.get("path"), spec.get("ec_path")):
                if path is None:
                    continue
                info = await self.client.get_file_info(path)
                if info is None or info.get("etag_md5") != spec["etag"] \
                        or int(info.get("size", -1)) != spec["size"]:
                    raise IncompleteCheckpointError(
                        f"step {step} shard {shard}: {path} is not "
                        "durably complete"
                    )
            return spec

        specs = await asyncio.gather(*(one(s) for s in range(self.num_shards)))
        return sorted(specs, key=lambda s: s["shard"])

    async def save(self, step: int, trees: dict[int, dict]) -> dict:
        """Single-caller save: write every shard, then commit. ``trees``
        maps shard id -> tensor tree and must cover all shards."""
        if sorted(trees) != list(range(self.num_shards)):
            raise ValueError(
                f"save(step={step}) needs trees for shards "
                f"0..{self.num_shards - 1}, got {sorted(trees)}")
        with self._op_scope(self.save_budget_s):
            await asyncio.gather(*(
                self.save_shard(step, shard, tree)
                for shard, tree in trees.items()
            ))
            return await self.commit(step)

    # --------------------------------------------------------------- listing

    async def list_steps(self) -> list[int]:
        """Published steps, ascending; only the manifest listing decides,
        so an in-flight or torn save is invisible here."""
        entries = await self.client.list_files_with_meta(
            ckptpaths.manifest_list_prefix(self.base), meta=False)
        steps = []
        for path, _ in entries:
            parsed = ckptpaths.parse_manifest_path(path)
            if parsed is not None and parsed[0] == self.base:
                steps.append(parsed[1])
        return sorted(steps)

    async def latest_step(self) -> int | None:
        steps = await self.list_steps()
        return steps[-1] if steps else None

    async def read_manifest(self, step: int | None = None) -> dict:
        if step is None:
            step = await self.latest_step()
            if step is None:
                raise CheckpointNotFoundError(
                    f"no published checkpoints under {self.base}")
        try:
            body = await self.client.get_file(
                ckptpaths.manifest_path(self.base, step))
        except Exception as e:
            if not is_dfs_error(e):
                raise
            raise CheckpointNotFoundError(
                f"checkpoint step {step} is not published under "
                f"{self.base}: {e}"
            ) from e
        return _validate_manifest(body)

    # --------------------------------------------------------------- restore

    def _restore_device(self, device):
        """``device`` resolved for a device restore (None stays None: host
        arrays). A device without a reader raises: no host fallback."""
        if device is None:
            return None
        if self.reader is None:
            raise ValueError(
                "restore(device=...) needs a reader (HbmReader); pass "
                "device=None for host numpy arrays")
        return resolve_device(device)

    async def restore(self, step: int | None = None, *,
                      shards: list[int] | None = None,
                      device=None) -> dict[int, dict]:
        """Parallel shard-wise restore of ``step`` (default: latest).
        Returns ``{shard: {name: array}}``: host numpy arrays, or torch
        tensors on ``device`` (through the reader)."""
        device = self._restore_device(device)
        manifest = await self.read_manifest(step)
        by_id = {s["shard"]: s for s in manifest["shards"]}
        want = sorted(by_id) if shards is None else list(shards)
        with self._op_scope(self.restore_budget_s):
            trees = await asyncio.gather(*(
                self.restore_shard(manifest, s, device=device) for s in want
            ))
        return dict(zip(want, trees))

    async def restore_shard(self, manifest: dict, shard: int, *,
                            device=None) -> dict:
        """One shard's tensors, CRC-verified end to end, degrading from
        the hot copy to the EC cold copy before giving up."""
        device = self._restore_device(device)
        spec = next((s for s in manifest["shards"] if s["shard"] == shard),
                    None)
        if spec is None:
            raise CheckpointNotFoundError(
                f"manifest step {manifest['step']} has no shard {shard}")
        with self._op_scope(self.restore_budget_s):
            if device is not None:
                tree = await restore_shard_device(
                    self.reader, self.client, spec, device, self.stats)
            else:
                payload = await self._read_shard_payload(spec)
                tree = unpack_shard(payload, spec["tensors"])
            self.stats["restored_shards"] += 1
            return tree

    async def _read_shard_payload(self, spec: dict) -> bytes:
        """Host-side shard bytes with the full fallback chain, whole-shard
        CRC checked against the manifest on every path."""
        sources = [p for p in (spec.get("path"), spec.get("ec_path"))
                   if p is not None]
        last: Exception | None = None
        for i, path in enumerate(sources):
            if i > 0:
                self.stats["degraded_shard_reads"] += 1
                logger.warning(
                    "shard %s: hot copy unreadable (%s); reconstructing "
                    "from EC cold copy %s", spec["shard"], last, path)
            try:
                payload = await self.client.get_file(path)
            except Exception as e:
                if not _is_read_error(e):
                    raise
                last = e
                continue
            if len(payload) == spec["size"] \
                    and crc32c(payload) == spec["crc32c"]:
                return payload
            last = ChecksumMismatchError(
                f"{path}: payload failed whole-shard CRC")
        raise DegradedRestoreError(
            f"shard {spec['shard']} unrestorable: every copy failed "
            f"({last})")

    # -------------------------------------------------------------- cleanup

    async def prune(self, keep: int = 2) -> list[int]:
        """Delete all but the newest ``keep`` published checkpoints: the
        manifest FIRST, then the step's data files (a crash between the two
        leaves only invisible garbage for GC)."""
        if keep < 1:
            raise ValueError("keep must be >= 1")
        doomed = (await self.list_steps())[:-keep]
        for step in doomed:
            await self.client.delete_file(
                ckptpaths.manifest_path(self.base, step))
            await self._delete_prefix(ckptpaths.step_prefix(self.base, step))
        return doomed

    async def gc_incomplete(self, *, max_age_ms: int = 3_600_000) -> list[str]:
        """Remove staging files of unpublished steps that are superseded or
        older than ``max_age_ms``, shielded from any ambient deadline and as
        the system tenant (cleanup must not be starved by the overload that
        produced the garbage)."""
        deleted: list[str] = []
        with self.scopes.shielded_from_deadline(), \
                self.scopes.as_system_tenant():
            published = set(await self.list_steps())
            latest = max(published, default=-1)
            now = int(time.time() * 1000)
            entries = await self.client.list_files_with_meta(
                ckptpaths.staging_root(self.base), meta=True)
            for path, meta in entries:
                parsed = ckptpaths.parse_step_path(path)
                if parsed is None or parsed[0] != self.base:
                    continue
                step = parsed[1]
                if step in published:
                    continue
                age = now - int((meta or {}).get("created_at_ms") or now)
                if latest > step or age >= max_age_ms:
                    await self.client.delete_file(path)
                    deleted.append(path)
                    self.stats["gc_deleted"] += 1
        return deleted

    async def _delete_prefix(self, prefix: str) -> None:
        entries = await self.client.list_files_with_meta(prefix, meta=False)
        await asyncio.gather(*(
            self.client.delete_file(path) for path, _ in entries
        ))
