#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        # needs one CUDA card; exits 1 without one

Builds the hand-written kernels from ``tpudfs_torch/gpu/csrc`` with nvcc
(and the block I/O library from ``native/`` with g++), holds each kernel
entry (per-chunk CRC32C, fused whole-block CRC32C, GF(2^8) matrix product)
against its plain PyTorch twin on the card, drives the verified read into
device memory at real size (the port's main path), times each entry at the
main path's shapes, and checks every byte that comes out.

Output (stdout): the card's ``nvidia-smi`` name and power limit, one JSON
line per phase (``device``, ``build``, ``kernels_vs_plain``, ``read_path``,
``ec_rebuild``, ``combined``, ``sweep``, ``infeed``, ``write``,
``ec_collective``, ``restore``, ``dataset``, ``kernel_times``,
``kernels``), the kernel table
``{"kernels": [...]}`` (each row at the read path's shape, with the write
side's shapes nested in it), and last
``{"ok": true, "device": {...}}``. Any mismatch raises: the run exits
non-zero and prints no result.

The read path: three replica stores laid out under ``build/`` in the
chunkserver's on-disk format (3x replication at rest) holding a 1 GiB file
of 16 x 64 MiB blocks and a 1,000,003-byte file (a tail block that is not
512-aligned), plus nine shard stores holding one 64 MiB RS(6,3) block with
shards 0, 2 and 7 missing. Everything is read through
``HbmReader(LocalClient(...))`` with ``verify="lazy"`` and settled with one
``confirm`` (twice: the first pass pays first-use costs, the second is
reported); a flipped byte in one replica must be flagged and recovered.
The same stores are then read by the batched paths, each with the launch
counts reset just before it and read just after:

- ``combined``: ``HbmReader(batch_reads=4)`` (the read combiner: one native
  pread into a pooled pinned buffer, one copy and one fused CRC launch per
  round of 4 blocks), two passes of the 1 GiB file (the second in reverse
  order, so every recycled buffer is refilled with other blocks' bytes),
  the first pass's blocks held until both are checked, and the tamper
  check through the combiner;
- ``sweep``: the native sweep pump over the 1 GiB and the tail file, twice,
  then once with a flipped byte in one replica (that slot alone falls back
  and is recovered);
- ``infeed``: ``DfsInfeed(...).as_sync_iterator()`` over both files.

Then the write side, each phase with the launch counts reset just before
it and read just after (ring positions go to distinct cards when there are
enough of them, else all to ``cuda:0``; each phase prints its mapping):

- ``write``: the collective write group (``IciWriteGroup``) at 3x
  replication on a 3-position ring, members that persist into port block
  stores on local disk; every position submits 4 blocks of 64 MiB at once
  (one round of B=4), twice, then one tampered round (a poisoned expected
  CRC) that must fail as a whole and persist nothing;
- ``ec_collective``: RS(6,3) scatter and gather of one 64 MiB block per
  position over a 9-position ring, the gather healthy and around position
  4 with its rows overwritten; and ``replicated_write_step(ec=(6,3))`` on
  the 3-ring against the host encoder.

Then the training job's two reads:

- ``restore``: one data-parallel rank's checkpoint shard at real size
  (Llama-2-7B's fp32 weights and Adam moments over 64 ranks: 1.264 GB, 19
  blocks of 64 MiB), packed by the port's ``pack_shard`` and laid out as
  the checkpoint manager saves it (a 3x-replicated hot copy and an RS(3,2)
  cold copy), restored into device memory by ``restore_shard_device``:
  healthy twice, with one byte flipped in one hot replica, and with one
  block's every hot replica corrupt and shards 0 and 3 of every cold-copy
  block missing (every block rebuilt on the card); every tensor bit-exact;
- ``dataset``: GPT-2 pretraining records (nanoGPT's block of 1,024 uint16
  tokens, batches of 12) from a 1 GiB 3x-replicated file through
  ``DfsRecordSource``, ``make_dataset`` and ``device_iterator``, a few
  hundred batches, each checked against the source.

Data is made from ``--seed`` with numpy (and with torch generators on the
card for the checkpoint's state).
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpudfs_torch.client.local import DfsError, LocalClient
from tpudfs_torch.chunkserver.blockstore import BlockStore
from tpudfs_torch.common import ckptpaths, native
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c, crc32c_fold
from tpudfs_torch.common.erasure import encode
from tpudfs_torch.gpu import host_to_device, u32_to_i64
from tpudfs_torch.gpu.checkpoint import pack_shard, restore_shard_device
from tpudfs_torch.gpu.crc32c_cuda import (
    block_crc_device,
    bytes_to_words,
    crc32c_blocks_device,
    crc32c_blocks_plain,
    crc32c_chunks_device,
    crc32c_chunks_plain,
    fold_table_device,
    inv_contrib,
    word_contrib_table,
)
from tpudfs_torch.gpu.hbm_reader import HbmReader, device_array_to_bytes
from tpudfs_torch.gpu.ici_replication import (
    EcShardGather,
    EcShardScatter,
    decode_select_matrices,
    make_mesh,
    replicated_write_step,
)
from tpudfs_torch.gpu.infeed import DfsInfeed
from tpudfs_torch.gpu.record_source import (
    DfsRecordSource,
    EpochSampler,
    device_iterator,
    make_dataset,
)
from tpudfs_torch.gpu.rs_cuda import (
    coef_bits,
    decode_matrix,
    gf_matmul_words,
    gf_rows_plain,
    matrix_bits_device,
    pad_shard_len,
    rs_decode_device,
)
from tpudfs_torch.gpu.write_group import IciWriteGroup

REPO = Path(__file__).resolve().parent
MiB = 1 << 20
#: Blocks per round of the ``combined`` phase (``HbmReader(batch_reads=)``).
COMBINED_BATCH = 4
#: H100 SXM HBM3 rate (NVIDIA data sheet), the bound's denominator.
HBM_BYTES_PER_S = 3.35e12
NO_LIBRARY = ("no single PyTorch call computes CRC32C or a GF(2^8) "
              "matrix product")
KERNELS = {
    "crc32c_chunks": {
        "route": "cuda", "source": "tpudfs_torch/gpu/csrc/crc32c.cu",
        "replaces": "tpudfs/tpu/crc32c_pallas.py:113",
        "wrapper": crc32c_chunks_device,
    },
    # The fused whole-block CRC: the chunk CRCs of _crc_pallas and the XLA
    # fold of block_crc_device (crc32c_pallas.py:150-172) in one launch.
    "crc32c_blocks": {
        "route": "cuda", "source": "tpudfs_torch/gpu/csrc/crc32c.cu",
        "replaces": "tpudfs/tpu/crc32c_pallas.py:113",
        "wrapper": crc32c_blocks_device,
    },
    "gf256_matmul": {
        "route": "cuda", "source": "tpudfs_torch/gpu/csrc/gf256.cu",
        "replaces": "tpudfs/tpu/rs_pallas.py:112",
        "wrapper": gf_matmul_words,
    },
}

#: The kernels each main-path phase must launch on the card: the combiner
#: verifies every round with the fused CRC; the sweep pump verifies on the
#: host, so its kernels run in the per-block fallbacks (the unaligned tail
#: block and the tampered slot); the infeed reads per block, eagerly; the
#: write group verifies every position's replicas with one chunk-CRC
#: launch; the EC collectives encode, CRC the sent and received shards, and
#: decode with runtime matrices; the checkpoint restore verifies every full
#: block with the fused CRC, its unaligned tail block with the chunk CRCs,
#: and rebuilds every cold-copy block with the GF(2^8) decode; the dataset
#: infeed reads records on the host and launches nothing.
PATH_KERNELS = {
    "read_path": ("crc32c_chunks", "crc32c_blocks", "gf256_matmul"),
    "combined": ("crc32c_blocks",),
    "sweep": ("crc32c_chunks", "crc32c_blocks"),
    "infeed": ("crc32c_chunks", "crc32c_blocks"),
    "write": ("crc32c_chunks",),
    "ec_collective": ("crc32c_chunks", "gf256_matmul"),
    "restore": ("crc32c_blocks", "crc32c_chunks", "gf256_matmul"),
    "dataset": (),
}
#: The write phase: 3x replication (BASELINE.json's HA layout) on a
#: 3-position ring, 4 blocks a position a round.
WRITE_RING = 3
WRITE_BLOCKS = 4


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def launches() -> dict[str, int]:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def sync(*devices: torch.device) -> None:
    for device in set(devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _same(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max |a - b| of two uint32 tensors, exact (as int64)."""
    return int((u32_to_i64(a) - u32_to_i64(b)).abs().max().item()) \
        if a.numel() else 0


def _random_words(rng, shape, device) -> torch.Tensor:
    return host_to_device(rng.integers(0, 1 << 32, shape, dtype=np.uint32),
                          device)


def _device_words(rng, shape, device) -> torch.Tensor:
    """Random uint32 words made on ``device`` (for grids of up to a GiB),
    from a generator seeded by ``rng``."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 62)))
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         device=device, generator=gen).view(torch.uint32)


# ------------------------------------------------------------ phase: read


def _block_meta(bid, size, locations, crc, **ec) -> dict:
    return {"block_id": bid, "size": size, "locations": list(locations),
            "checksum_crc32c": crc, "ec_data_shards": ec.get("k", 0),
            "ec_parity_shards": ec.get("m", 0),
            "original_size": size if ec else 0}


def _stores(workdir: Path, n: int) -> tuple[list, dict, dict]:
    """n chunkserver stores under ``workdir``: (addrs, ``LocalClient``
    stores, open ``BlockStore`` handles)."""
    addrs = [f"cs{i}:7000" for i in range(n)]
    stores = {a: (workdir / f"cs{i}" / "hot", None) for i, a in enumerate(addrs)}
    handles = {a: BlockStore(hot, cold) for a, (hot, cold) in stores.items()}
    return addrs, stores, handles


def _write_replicated(handles: dict, addrs: list, path: str, data: np.ndarray,
                     block_size: int, tag: str | None = None) -> dict:
    """``data`` as a file of ``block_size`` blocks at 3x replication on
    the first three stores (block i's first replica on store i % 3), each
    replica with its sidecar CRCs (the native CRC); returns the file's
    GetFileInfo-shaped meta. Block ids are ``blk_<tag>_<i>``, the tag by
    default from the path."""
    tag = tag or path.strip("/").replace("/", "_")
    blocks = []
    for i, off in enumerate(range(0, len(data), block_size)):
        piece = data[off : off + block_size]
        sums = native.crc32c_chunks(piece)
        bid = f"blk_{tag}_{i}"
        locs = [addrs[(i + r) % 3] for r in range(3)]
        for a in locs:
            handles[a].write(bid, piece, sums)
        blocks.append(_block_meta(bid, len(piece), locs,
                                  crc32c_fold(sums, len(piece),
                                              CHECKSUM_CHUNK_SIZE)))
    return {"path": path, "size": len(data), "blocks": blocks}


def lay_out(workdir: Path, rng, *, block_size: int, nblocks: int,
            tail_size: int, ec: tuple, lost: tuple) -> tuple:
    """Stores in the chunkserver's format + GetFileInfo-shaped metas.
    Returns (stores, metas, sources): ``sources[path]`` is the file's bytes."""
    k, m = ec
    addrs, stores, handles = _stores(workdir, max(3, k + m))
    metas, sources = {}, {}
    for path, nbytes in (("/smoke/big", nblocks * block_size),
                         ("/smoke/tail", tail_size)):
        sources[path] = np.frombuffer(rng.bytes(nbytes), dtype=np.uint8)
        metas[path] = _write_replicated(handles, addrs, path, sources[path],
                                       block_size)
    ecdata = rng.bytes(block_size)
    shards = encode(ecdata, k, m)
    for i, shard in enumerate(shards):
        if i not in lost:
            handles[addrs[i]].write("blk_smoke_ec_0", shard)
    crc = crc32c_fold(native.crc32c_chunks(ecdata), block_size,
                      CHECKSUM_CHUNK_SIZE)
    metas["/smoke/ec"] = {"path": "/smoke/ec", "size": block_size, "blocks": [
        _block_meta("blk_smoke_ec_0", block_size, addrs[: k + m], crc, k=k, m=m)
    ]}
    sources["/smoke/ec"] = np.frombuffer(ecdata, dtype=np.uint8)
    return stores, metas, sources


def _check_bytes(blocks, data: np.ndarray, path: str) -> None:
    off = 0
    for b in blocks:
        got = device_array_to_bytes(b.array, b.size)
        if got != data[off : off + b.size].tobytes():
            raise AssertionError(f"{path}: block {b.block_id} bytes differ")
        off += b.size
    if off != len(data):
        raise AssertionError(f"{path}: read {off} of {len(data)} bytes")


async def _pass(reader: HbmReader, sources, device) -> dict:
    """One clean read of all three files and one confirm for all blocks."""
    sync(device)
    t0 = time.perf_counter()
    big = await reader.read_file_to_device_blocks("/smoke/big", verify="lazy")
    sync(device)  # the timed window holds no device->host copy
    read_s = time.perf_counter() - t0
    tail = await reader.read_file_to_device_blocks("/smoke/tail", verify="lazy")
    sync(device)
    t0 = time.perf_counter()
    ec = await reader.read_file_to_device_blocks("/smoke/ec", verify="lazy")
    sync(device)
    ec_read_s = time.perf_counter() - t0
    every = big + tail + ec
    pending = sum(b.pending_crc is not None for b in every)
    t0 = time.perf_counter()
    await reader.confirm(every)
    confirm_s = time.perf_counter() - t0
    if not all(b.verified for b in every) or reader.rereads:
        raise AssertionError("clean read did not verify every block")
    for path, blocks in (("/smoke/big", big), ("/smoke/tail", tail),
                         ("/smoke/ec", ec)):
        _check_bytes(blocks, sources[path], path)
    read_bytes = sum(b.size for b in big)
    return {"read_bytes": read_bytes, "read_s": read_s,
            "gbps": read_bytes / read_s / 1e9, "confirm_s": confirm_s,
            "ec_read_s": ec_read_s,
            "blocks": len(every), "pending_at_confirm": pending,
            "tail_block_bytes": tail[-1].size}


async def _host_breakdown(client: LocalClient, metas, device) -> dict:
    """The read window's host steps alone, at the same concurrency: the
    pread of every block of the big file into fresh grids, then their
    pageable host->device copies; on a card, the copy rate from one pinned
    buffer; and the native engine's batched pread of the same blocks in
    rounds of 4 into one reused buffer (pinned on a card), without and with
    its fused CRC: the combiner's fill and the sweep producer's."""
    blocks = metas["/smoke/big"]["blocks"]
    nbytes = sum(b["size"] for b in blocks)
    t0 = time.perf_counter()
    grids = await asyncio.gather(*(
        client._read_block_range(b, 0, 0, local_verify=False,
                                 into=lambda n: np.zeros(n, np.uint8))
        for b in blocks))
    pread_s = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    await asyncio.gather(*(asyncio.to_thread(torch.from_numpy(g).to, device)
                           for g in grids))
    sync(device)
    out = {"pread_gbps": nbytes / pread_s / 1e9,
           "h2d_pageable_gbps": nbytes / (time.perf_counter() - t0) / 1e9}
    if device.type == "cuda":
        pinned = torch.from_numpy(grids[0]).pin_memory()
        dst = torch.empty_like(pinned, device=device)
        sync(device)
        t0 = time.perf_counter()
        for _ in blocks:
            dst.copy_(pinned, non_blocking=True)
        sync(device)
        out["h2d_pinned_gbps"] = nbytes / (time.perf_counter() - t0) / 1e9
    paths = [str(client._local_stores[b["locations"][0]][0]
                 .block_path(b["block_id"])) for b in blocks]
    stride = blocks[0]["size"]
    buf = torch.empty(COMBINED_BATCH * stride, dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    for key, with_crc in (("native_pread_gbps", False),
                          ("native_pread_crc_gbps", True)):
        t0 = time.perf_counter()
        for i in range(0, len(paths), COMBINED_BATCH):
            native.blocks_read(paths[i : i + COMBINED_BATCH], stride,
                               buf.data_ptr(), with_crc=with_crc)
        out[key] = nbytes / (time.perf_counter() - t0) / 1e9
    return out


def _part_ms(fn, device, held: bool = True) -> float:
    """Time of one call of ``fn``: on a card ``kernels.time_ms`` (``held``:
    device time alone), on the CPU the median of 5 host-clock runs."""
    if device.type == "cuda":
        return _time_ms(fn, device, held)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


async def _ec_rebuild(client: LocalClient, metas, device) -> dict:
    """The degraded EC block's rebuild (``hbm_reader.py:194-204``) in its
    parts, each timed alone on the reader's own inputs: the pageable
    host->device copy of the (k, padded) stack of survivors (one call, the
    host's part included), the decode kernel (device time), and the copy
    that ``recon[:, :slen].reshape(-1)`` makes on the device (the shard is
    padded to 128 bytes, so the slice is not contiguous); and the three in
    a row, one call."""
    block = metas["/smoke/ec"]["blocks"][0]
    k, m = int(block["ec_data_shards"]), int(block["ec_parity_shards"])
    shards = await client._read_ec_shards(block, local_verify=False)
    use = tuple(i for i, s in enumerate(shards) if s is not None)[:k]
    slen = len(shards[use[0]])
    stack = np.zeros((k, pad_shard_len(slen)), dtype=np.uint8)
    for r, idx in enumerate(use):
        stack[r, :slen] = np.frombuffer(shards[idx], dtype=np.uint8)
    avail = torch.from_numpy(stack).to(device)
    recon = rs_decode_device(avail, k, m, use)

    def whole():
        out = rs_decode_device(torch.from_numpy(stack).to(device), k, m, use)
        return out[:, :slen].reshape(-1)

    return {
        "phase": "ec_rebuild", "device": str(device), "k": k, "m": m,
        "shard_bytes": slen, "padded_shard_bytes": stack.shape[1],
        "timer": "cuda events (kernel_ms, slice_copy_ms: stream held; "
                 "h2d_ms, whole_ms: one call)" if device.type == "cuda"
                 else "host clock, median of 5",
        "h2d_ms": _part_ms(lambda: torch.from_numpy(stack).to(device),
                           device, held=False),
        "kernel_ms": _part_ms(lambda: rs_decode_device(avail, k, m, use),
                              device),
        "slice_copy_ms": _part_ms(lambda: recon[:, :slen].reshape(-1), device),
        "whole_ms": _part_ms(whole, device, held=False),
    }


def _flip_first_replica(client: LocalClient, block: dict,
                        replica: int = 0) -> None:
    """Flip one byte of the block's first (or ``replica``-th) replica (a
    second call undoes it)."""
    store = client._local_stores[block["locations"][replica]][0]
    pos = min(12345, block["size"] - 1)
    with open(store.block_path(block["block_id"]), "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x40]))


async def _tamper(reader: HbmReader, client: LocalClient, metas, sources,
                  device) -> dict:
    """Flip one byte in the first replica of one block: confirm must flag it
    (raise without retry), and with retry recover it from another replica.
    The byte is flipped back after."""
    blocks = metas["/smoke/big"]["blocks"]
    i = len(blocks) // 2
    block = blocks[i]
    _flip_first_replica(client, block)
    try:
        db = await reader.read_block_to_device(block, device, verify="lazy")
        try:
            await reader.confirm([db], retry=False)
        except DfsError as e:
            if block["block_id"] not in str(e):
                raise
        else:
            raise AssertionError("confirm did not flag the tampered replica")
        before = reader.rereads
        db = await reader.read_block_to_device(block, device, verify="lazy")
        await reader.confirm([db])
    finally:
        _flip_first_replica(client, block)
    if reader.rereads != before + 1 or not db.verified:
        raise AssertionError("tampered block was not recovered")
    size = block["size"]
    want = sources["/smoke/big"][i * size : (i + 1) * size].tobytes()
    if device_array_to_bytes(db.array, db.size) != want:
        raise AssertionError("recovered block bytes differ")
    return {"block": block["block_id"], "flagged": True, "recovered": True}


# ------------------------------------------------- phases: batched paths


async def _combined(client: LocalClient, metas, sources, device,
                    batch: int = COMBINED_BATCH) -> dict:
    """The read combiner: two passes of the big file (the second through
    ``read_meta_blocks_fast`` in reverse block order), the first pass's
    blocks held until both passes are checked byte for byte; then the
    tamper check through the combiner."""
    meta = metas["/smoke/big"]
    nblocks = len(meta["blocks"])
    cpb = meta["blocks"][0]["size"] // CHECKSUM_CHUNK_SIZE
    reader = HbmReader(client, [device], batch_reads=batch)
    t0 = time.perf_counter()
    reader.warm_batches(cpb)
    warm_s = time.perf_counter() - t0
    comb = reader._combiner(device)
    passes, held = [], []
    for reverse in (False, True):
        rounds, blocks0 = comb.rounds, comb.blocks
        launches0 = crc32c_blocks_device.launches
        stage0 = dict(comb.stage_s)
        sync(device)
        t0 = time.perf_counter()
        if reverse:
            got = await reader.read_meta_blocks_fast(
                {**meta, "blocks": meta["blocks"][::-1]}, device)
        else:
            got = await reader.read_file_to_device_blocks("/smoke/big",
                                                          verify="lazy")
        sync(device)  # the timed window holds no device->host copy
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        await reader.confirm(got)
        confirm_s = time.perf_counter() - t0
        p = {"read_s": read_s, "gbps": sum(b.size for b in got) / read_s / 1e9,
             "confirm_s": confirm_s, "rounds": comb.rounds - rounds,
             "blocks": comb.blocks - blocks0,
             "crc32c_blocks_launches": crc32c_blocks_device.launches - launches0,
             "stage_s": _delta(comb.stage_s, stage0)}
        want_launches = p["rounds"] if device.type == "cuda" else 0
        # Rounds are powers of two of at most `batch` blocks.
        want_rounds = nblocks // batch + bin(nblocks % batch).count("1")
        if p["blocks"] != nblocks or p["rounds"] != want_rounds \
                or p["crc32c_blocks_launches"] != want_launches:
            raise AssertionError(f"combined pass did not fuse as expected: {p}")
        if not all(b.verified for b in got) or reader.rereads:
            raise AssertionError("combined pass did not verify every block")
        passes.append(p)
        held.append(got[::-1] if reverse else got)
    for got in held:
        _check_bytes(got, sources["/smoke/big"], "/smoke/big")
    tamper = await _tamper(reader, client, metas, sources, device)
    pooled = [b for bufs in comb._buf_pool.values() for b in bufs]
    if device.type == "cuda" and not all(b.is_pinned() for b in pooled):
        raise AssertionError("a pooled round buffer is not pinned")
    return {"phase": "combined", "device": str(device), "batch_reads": batch,
            "host_verify": comb.host_verify, "warm_s": warm_s,
            "read_bytes": sum(b["size"] for b in meta["blocks"]),
            **passes[1], "first_pass": passes[0], "tamper": tamper,
            "pooled_buffers": len(pooled)}


async def _sweep(client: LocalClient, metas, sources, device,
                 round_blocks: int = 4, ring: int = 3) -> dict:
    """The native sweep pump over the big and the tail file, twice (the
    unaligned tail block falls back to the per-block path), then once with
    a flipped byte in one replica: that slot alone falls back and the
    per-block path recovers it."""
    paths = ["/smoke/big", "/smoke/tail"]
    nbig = len(metas["/smoke/big"]["blocks"])
    nbytes = sum(b["size"] for p in paths for b in metas[p]["blocks"])
    reader = HbmReader(client, [device])

    async def one_pass() -> tuple[float, int]:
        before = reader.sweep_blocks
        stage0 = dict(reader.sweep_stage_s)
        sync(device)
        t0 = time.perf_counter()
        got = await reader.sweep_paths_to_device(
            paths, round_blocks=round_blocks, ring=ring)
        sync(device)
        seconds = time.perf_counter() - t0
        if not all(b.verified for b in got):
            raise AssertionError("sweep returned an unverified block")
        _check_bytes(got[:nbig], sources["/smoke/big"], "/smoke/big")
        _check_bytes(got[nbig:], sources["/smoke/tail"], "/smoke/tail")
        stages.append(_delta(reader.sweep_stage_s, stage0))
        return seconds, reader.sweep_blocks - before

    passes, stages = [], []
    for i in range(2):
        seconds, served = await one_pass()
        if served != nbig:
            raise AssertionError(f"sweep pump served {served} of {nbig} blocks")
        passes.append({"read_s": seconds, "gbps": nbytes / seconds / 1e9,
                       "sweep_blocks": served, "stage_s": stages[i]})
    block = metas["/smoke/big"]["blocks"][nbig // 2]
    _flip_first_replica(client, block)
    try:
        rereads = reader.rereads
        _, served = await one_pass()
    finally:
        _flip_first_replica(client, block)
    if served != nbig - 1 or reader.rereads != rereads + 1:
        raise AssertionError("the tampered slot did not fall back alone")
    return {"phase": "sweep", "device": str(device),
            "round_blocks": round_blocks, "ring": ring, "read_bytes": nbytes,
            **passes[1], "first_pass": passes[0],
            "tamper": {"block": block["block_id"], "fell_back": True,
                       "recovered": True}}


def _infeed(client: LocalClient, sources, device) -> dict:
    """One pass of ``DfsInfeed`` (per-block reads, verified eagerly)."""
    paths = ["/smoke/big", "/smoke/tail"]
    seen = []
    t0 = time.perf_counter()
    for path, blocks in DfsInfeed(client, paths, [device]).as_sync_iterator():
        if not all(b.verified for b in blocks):
            raise AssertionError(f"infeed: {path} not verified")
        _check_bytes(blocks, sources[path], path)
        seen.append(path)
    if seen != paths:
        raise AssertionError(f"infeed yielded {seen}")
    return {"phase": "infeed", "device": str(device), "files": len(seen),
            "seconds": time.perf_counter() - t0}


def _delta(now: dict, before: dict) -> dict:
    return {k: now[k] - before[k] for k in now}


def _counted(run) -> dict:
    """Run one phase with the launch counts set to 0 just before it; the
    phase's result gains its launches."""
    reset_launches()
    out = run()
    out["launches"] = launches()
    return out


def read_path(device: torch.device, *, block_size: int = 64 * MiB,
              nblocks: int = 16, tail_size: int = 1_000_003,
              ec: tuple = (6, 3), lost: tuple = (0, 2, 7), seed: int = 0,
              workdir: Path | None = None) -> dict:
    """Lay out the stores, then read everything into ``device`` memory
    through the port (see the module docstring). Raises on any mismatch;
    returns the phase's numbers, including the kernel launches of the run."""
    root = Path(workdir) if workdir is not None else REPO / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=root))
    try:
        t0 = time.perf_counter()
        stores, metas, sources = lay_out(
            tmp, np.random.default_rng(seed), block_size=block_size,
            nblocks=nblocks, tail_size=tail_size, ec=ec, lost=lost)
        setup_s = time.perf_counter() - t0
        client = LocalClient(stores, metas)
        reader = HbmReader(client, [device])
        reset_launches()
        # Pass 1 meets every first-use cost (constant tables uploaded,
        # CUDA modules loaded); pass 2 is the steady state.
        passes = [asyncio.run(_pass(reader, sources, device))
                  for _ in range(2)]
        tamper = asyncio.run(_tamper(reader, client, metas, sources, device))
        counts = launches()
        host = asyncio.run(_host_breakdown(client, metas, device))
        ec_rebuild = asyncio.run(_ec_rebuild(client, metas, device))
        combined = _counted(lambda: asyncio.run(
            _combined(client, metas, sources, device)))
        sweep = _counted(lambda: asyncio.run(
            _sweep(client, metas, sources, device)))
        infeed = _counted(lambda: _infeed(client, sources, device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "read_path", "device": str(device), "seed": seed,
            "block_size": block_size, "nblocks": nblocks,
            "tail_size": tail_size, "ec": list(ec), "ec_lost": list(lost),
            "replicas": 3, "setup_s": setup_s, **passes[-1],
            "first_pass": passes[0], "host": host, "tamper": tamper,
            "launches": counts, "ec_rebuild": ec_rebuild,
            "combined": combined, "sweep": sweep, "infeed": infeed}


# ------------------------------------------------------ phases: write side


def ring_devices(device: torch.device, n: int) -> tuple[list, str]:
    """n ring positions: distinct cards when ``device`` is a card and there
    are at least n of them, else every position on ``device``."""
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], "distinct cards"
    return [device] * n, f"all {n} positions on {device}"


class StoreMember:
    """A write-group member: an address and a port ``BlockStore`` on local
    disk, persisting each replica with its per-chunk CRCs (the native CRC,
    as a chunkserver's committer computes them)."""

    def __init__(self, address: str, root: Path):
        self.address = address
        self.store = BlockStore(root)

    async def persist_ici_replica(self, block_id, data, master_term,
                                  master_shard) -> bool:
        await asyncio.to_thread(lambda: self.store.write(
            block_id, data, native.crc32c_chunks(data)))
        return True


def _read_back(members, datas: dict) -> int:
    """Every member's store holds every block, ``read_verified`` (its
    sidecar CRCs checked) to its bytes; returns the copies checked."""
    from concurrent.futures import ThreadPoolExecutor

    def check(job) -> None:
        member, bid = job
        if member.store.read_verified(bid) != datas[bid]:
            raise AssertionError(f"{member.address}: {bid} bytes differ")

    jobs = [(mb, bid) for mb in members for bid in datas]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(check, jobs))
    return len(jobs)


async def _write(devices, root: Path, rng, *, block_size: int,
                 nblocks: int) -> dict:
    n = len(devices)
    members = [StoreMember(f"cs{i}:7000", root / f"w{i}") for i in range(n)]
    group = IciWriteGroup(make_mesh(devices), [mb.address for mb in members],
                          replication=n)
    for i, mb in enumerate(members):
        group.attach(mb, i)
    cpb = -(-block_size // CHECKSUM_CHUNK_SIZE)
    t0 = time.perf_counter()
    group.warm(cpb, nblocks)
    warm_s = time.perf_counter() - t0
    reset_launches()

    async def one_pass(tag: str) -> dict:
        datas = {f"blk_{tag}_{p}_{j}": rng.bytes(block_size)
                 for p in range(n) for j in range(nblocks)}
        stage0, rounds0 = dict(group.stage_s), group.stats.rounds
        sync(*devices)
        t0 = time.perf_counter()
        got = await asyncio.gather(*(
            group.submit(int(bid.split("_")[2]), bid, d, 1, "smoke")
            for bid, d in datas.items()))
        sync(*devices)
        seconds = time.perf_counter() - t0
        if got != [n] * len(datas) or group.stats.last_acks != n:
            raise AssertionError(f"write pass {tag}: replicas {got}, acks "
                                 f"{group.stats.last_acks}")
        nbytes = sum(map(len, datas.values()))
        return {"bytes": nbytes, "seconds": seconds,
                "gbps": nbytes / seconds / 1e9,
                "rounds": group.stats.rounds - rounds0,
                "acks": group.stats.last_acks,
                "stage_s": _delta(group.stage_s, stage0),
                "copies_read_back": _read_back(members, datas)}

    try:
        passes = [await one_pass("first"), await one_pass("steady")]
        tamper = await _write_tamper(group, members, rng, block_size)
    finally:
        await group.stop()
    host = await _write_host_parts(devices[0], members[0], rng, block_size,
                                   n * nblocks)
    return {"phase": "write", "devices": [str(d) for d in devices],
            "replication": n, "block_size": block_size,
            "blocks_per_position": nblocks, "warm_s": warm_s,
            **passes[1], "first_pass": passes[0],
            "blocks": group.stats.blocks,
            "round_failures": group.stats.round_failures,
            "persist_failures": group.stats.persist_failures,
            "tamper": tamper, "host": host, "launches": launches()}


async def _write_host_parts(device, member, rng, block_size: int,
                            nblocks: int) -> dict:
    """The host steps of one position's drain and persist, each alone at
    that position's size (``nblocks`` blocks of R=3 replica groups): the
    device->host copy into fresh pageable memory (what the group's drain
    does), the same into one pinned buffer (on a card), the cut of the host
    copy into one bytes object per block, and one block's persist (native
    CRC + the store's durable write, fsync included)."""
    nbytes = nblocks * block_size
    src = torch.empty(nbytes // 4, dtype=torch.int32, device=device)
    sync(device)
    t0 = time.perf_counter()
    flat = src.cpu().numpy().view(np.uint8)
    out = {"bytes": nbytes,
           "d2h_pageable_gbps": nbytes / (time.perf_counter() - t0) / 1e9}
    if device.type == "cuda":
        pinned = torch.empty(nbytes // 4, dtype=torch.int32, pin_memory=True)
        pinned.copy_(src)  # the first copy maps the buffer
        t0 = time.perf_counter()
        pinned.copy_(src)
        out["d2h_pinned_gbps"] = nbytes / (time.perf_counter() - t0) / 1e9
        del pinned
    t0 = time.perf_counter()
    cut = [flat[o : o + block_size].tobytes()
           for o in range(0, nbytes, block_size)]
    out["cut_gbps"] = nbytes / (time.perf_counter() - t0) / 1e9
    del cut, src
    data = rng.bytes(block_size)
    t0 = time.perf_counter()
    await member.persist_ici_replica("blk_persist_alone", data, 1, "smoke")
    out["persist_one_block_s"] = time.perf_counter() - t0
    return out


async def _write_tamper(group, members, rng, block_size: int) -> dict:
    """One round with position 1's first expected CRC poisoned: it must
    fail as a whole (acks below the positions, one round failure, every
    future raising the group's ``Error``) and persist nothing."""
    n = len(members)
    real = group.replicator.replicate

    def poisoned(words, crcs):
        crcs = [c.clone() for c in crcs]
        crcs[1].view(torch.int32)[0] ^= 0x5A5A5A5A
        return real(words, crcs)

    failures0 = group.stats.round_failures
    bids = [f"blk_tamper_{p}" for p in range(n)]
    group.replicator.replicate = poisoned
    try:
        got = await asyncio.gather(
            *(group.submit(p, bid, rng.bytes(block_size), 1, "smoke")
              for p, bid in enumerate(bids)), return_exceptions=True)
    finally:
        group.replicator.replicate = real
    stored = [bid for mb in members for bid in bids
              if mb.store.block_path(bid).exists()]
    if (not all(isinstance(e, group.Error) for e in got)
            or group.stats.round_failures != failures0 + 1
            or group.stats.last_acks >= n or stored):
        raise AssertionError(f"tampered round did not fail as a whole: {got}, "
                             f"acks {group.stats.last_acks}, stored {stored}")
    return {"acks": group.stats.last_acks, "round_failures": 1,
            "futures_failed": len(got), "persisted": 0}


def write_path(device: torch.device, *, block_size: int = 64 * MiB,
               nblocks: int = WRITE_BLOCKS, seed: int = 0,
               workdir: Path | None = None) -> dict:
    """The ``write`` phase (see the module docstring); the stores live in a
    temporary directory under ``workdir`` (default ``build/``), removed at
    the end."""
    devices, mapping = ring_devices(device, WRITE_RING)
    root = Path(workdir) if workdir is not None else REPO / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_write_", dir=root))
    try:
        out = asyncio.run(_write(devices, tmp, np.random.default_rng(seed + 1),
                                 block_size=block_size, nblocks=nblocks))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {**out, "mapping": mapping}


def _data_matches(recon: torch.Tensor, words: torch.Tensor) -> bool:
    """The first len(words) bytes of the (k, S, 128) data shards are the
    source words, compared on their device."""
    n = words.numel()
    return torch.equal(recon.view(torch.int32).reshape(-1)[:n],
                       words.view(torch.int32).reshape(-1))


def ec_collective(device: torch.device, *, block_size: int = 64 * MiB,
                  ec: tuple = (6, 3), seed: int = 0) -> dict:
    """The ``ec_collective`` phase: RS(k,m) scatter and gather of one block
    per position over a (k+m)-position ring (every position's data back
    bit-exact, healthy and around position 4 with its rows garbage), then
    ``replicated_write_step(ec=)`` on the 3-ring, its parity against the
    host encoder. The first scatter and gather pay first-use costs; the
    second of each is timed (host clock, ended by a synchronize)."""
    k, m = ec
    devices, mapping = ring_devices(device, k + m)
    rng = np.random.default_rng(seed + 2)
    mesh = make_mesh(devices)
    cpb = block_size // CHECKSUM_CHUNK_SIZE
    words = [_device_words(rng, (cpb, 128), d) for d in devices]
    scatter, gather = EcShardScatter(mesh, k, m), EcShardGather(mesh, k, m)
    gather.gather(scatter.scatter(words)[0])
    sync(*devices)
    reset_launches()
    t0 = time.perf_counter()
    shards, ok, acks = scatter.scatter(words)
    acks = int(acks)
    shards_s = shards[0].shape[1]  # chunks of one shard
    sync(*devices)
    scatter_s = time.perf_counter() - t0
    if acks != k + m or not all(bool(o) for o in ok):
        raise AssertionError(f"EC scatter verified on {acks}/{k + m}")
    after_scatter = launches()
    times = {}
    for failed in (None, 4):
        if failed is not None:
            shards[failed].view(torch.int32).fill_(0x25A5A5A5)
        sync(*devices)
        t0 = time.perf_counter()
        recon = gather.gather(shards, failed=failed)
        sync(*devices)
        times[failed] = time.perf_counter() - t0
        bad = [p for p in range(k + m) if not _data_matches(recon[p], words[p])]
        if bad:
            raise AssertionError(f"EC gather (failed={failed}): positions "
                                 f"{bad} differ")
    after_gather = launches()
    del shards, recon
    ring, _ = ring_devices(device, WRITE_RING)
    host = [np.frombuffer(rng.bytes(block_size), dtype=np.uint8)
            for _ in ring]
    step = replicated_write_step(make_mesh(ring), WRITE_RING, ec=ec)
    out = step([host_to_device(bytes_to_words(h), d)
                for h, d in zip(host, ring)],
               [host_to_device(native.crc32c_chunks(h), d)
                for h, d in zip(host, ring)])
    if int(out["acks"]) != WRITE_RING:
        raise AssertionError(f"write step acks {int(out['acks'])}")
    # The step pads each shard to 128 bytes (pad_shard_len), so the host
    # encoder gets the block zero-padded to k such shards: the same split.
    slen = pad_shard_len(-(-block_size // k))
    for p, (h, parity) in enumerate(zip(host, out["parity"])):
        padded = np.zeros(k * slen, dtype=np.uint8)
        padded[: len(h)] = h
        want = np.stack([np.frombuffer(x, dtype=np.uint8)
                         for x in encode(padded, k, m)[k:]])
        if not np.array_equal(parity.cpu().numpy(), want):
            raise AssertionError(f"write step parity differs at position {p}")
    total = launches()
    gf = "gf256_matmul"
    # Encodes: the scatter's and the write step's; decodes: the gathers'.
    gf_encodes = after_scatter[gf] + total[gf] - after_gather[gf]
    gf_decodes = after_gather[gf] - after_scatter[gf]
    return {"phase": "ec_collective", "devices": [str(d) for d in devices],
            "mapping": mapping, "ec": [k, m], "block_size": block_size,
            "shard_bytes": shards_s * CHECKSUM_CHUNK_SIZE,
            "scatter_acks": acks, "scatter_s": scatter_s,
            "gather_s": times[None], "gather_degraded_s": times[4],
            "gather_failed": 4, "exact": True,
            "write_step": {"devices": [str(d) for d in ring],
                           "acks": int(out["acks"]), "parity_exact": True},
            "scatter_launches": after_scatter,
            "gf256_launches": {"encode": gf_encodes, "decode": gf_decodes},
            "launches": total}


# ------------------------------------------------------- phase: restore

#: One data-parallel rank's checkpoint shard at real size: Llama-2-7B's
#: 6.74e9 parameters (Touvron et al. 2023, Table 1) as fp32 master weights
#: plus Adam's two moments, K = 12 bytes a parameter (ZeRO, Rajbhandari et
#: al. 2020, section 3.1), partitioned over 64 data-parallel ranks.
LLAMA2_7B_PARAMS = 6_740_000_000
CKPT_RANKS = 64
CKPT_PARAMS = LLAMA2_7B_PARAMS // CKPT_RANKS  # 105,312,500: 1.264 GB a rank
#: The checkpoint manager's default cold copy (``CheckpointManager(ec=)``)
#: and the shards the degraded run loses from every block of it.
CKPT_EC = (3, 2)
CKPT_LOST = (0, 3)


def ckpt_state(n: int, seed: int, device: torch.device) -> dict:
    """One rank's state, made on ``device`` from ``seed``: flat fp32
    ``params``, ``adam_m`` and ``adam_v`` of ``n`` elements each, an int64
    ``step`` and an int8 ``flags`` tensor of 13. The last two are not
    4-byte dtypes, so they take the host bounce, and ``step``, last in name
    order, ends the payload off a 512-byte boundary."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tree = {name: torch.randn(n, generator=gen, device=device)
            for name in ("params", "adam_m", "adam_v")}
    tree["flags"] = torch.randint(-128, 128, (13,), dtype=torch.int8,
                                  generator=gen, device=device)
    tree["step"] = torch.tensor(1000 + seed, dtype=torch.int64, device=device)
    return tree


def lay_out_shard(workdir: Path, payload: np.ndarray, *, block_size: int,
                  hot: str, cold: str, ec: tuple = CKPT_EC) -> tuple:
    """A shard payload as the checkpoint manager saves it: a 3x-replicated
    hot copy at ``hot`` and an RS(k,m) cold copy at ``cold`` (the host
    encoder; shard j of every block on store j). Returns (stores, metas)."""
    k, m = ec
    addrs, stores, handles = _stores(workdir, max(3, k + m))
    metas = {hot: _write_replicated(handles, addrs, hot, payload, block_size,
                                   tag="ckpt_hot")}
    blocks = []
    for i, off in enumerate(range(0, len(payload), block_size)):
        piece = payload[off : off + block_size]
        bid = f"blk_ckpt_ec_{i}"
        for j, shard in enumerate(encode(piece, k, m)):
            handles[addrs[j]].write(bid, shard, native.crc32c_chunks(shard))
        crc = metas[hot]["blocks"][i]["checksum_crc32c"]
        blocks.append(_block_meta(bid, len(piece), addrs[: k + m], crc,
                                  k=k, m=m))
    metas[cold] = {"path": cold, "size": len(payload), "blocks": blocks}
    return stores, metas


def _drop_shards(client: LocalClient, meta: dict, lost: tuple) -> None:
    """Delete shards ``lost`` of every block of an EC file (block and
    sidecar)."""
    for block in meta["blocks"]:
        for j in lost:
            store = client._local_stores[block["locations"][j]][0]
            path = store.block_path(block["block_id"])
            path.unlink()
            path.with_name(path.name + ".meta").unlink()


def _check_restored(out: dict, tree: dict, device: torch.device) -> None:
    """Every tensor bit-exact, of its dtype and shape, on ``device``; the
    4-byte ones views of one word stream (no copy made)."""
    if sorted(out) != sorted(tree):
        raise AssertionError(f"restore: tensors {sorted(out)}")
    stream = set()
    for name, want in tree.items():
        got = out[name]
        if (got.dtype, got.shape, got.device) != (want.dtype, want.shape,
                                                  device):
            raise AssertionError(f"restore: {name} is {got.dtype} "
                                 f"{tuple(got.shape)} on {got.device}")
        if not torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"restore: {name} bytes differ")
        if want.element_size() == 4:
            stream.add(got.untyped_storage().data_ptr())
    if len(stream) != 1:
        raise AssertionError("restore: the 4-byte tensors are not views of "
                             "one word stream")


async def _restore_run(reader: HbmReader, client: LocalClient, spec: dict,
                       device: torch.device, tree: dict) -> dict:
    """One ``restore_shard_device`` call, timed from the call to the last
    tensor (ended by a synchronize), then checked against ``tree``."""
    stats = {"degraded_shard_reads": 0}
    stage = dict.fromkeys(("read", "combined_crc", "assemble", "bounce"), 0.0)
    rereads, before = reader.rereads, launches()
    sync(device)
    t0 = time.perf_counter()
    out = await restore_shard_device(reader, client, spec, device, stats,
                                     stage_s=stage)
    sync(device)
    seconds = time.perf_counter() - t0
    _check_restored(out, tree, device)
    return {"seconds": seconds, "gbps": spec["size"] / seconds / 1e9,
            "stage_s": stage, "rereads": reader.rereads - rereads,
            "degraded_shard_reads": stats["degraded_shard_reads"],
            "launches": _delta(launches(), before)}


def restore_path(device: torch.device, *, params: int = CKPT_PARAMS,
                 block_size: int = 64 * MiB, seed: int = 0,
                 workdir: Path | None = None) -> dict:
    """The ``restore`` phase: one rank's checkpoint shard (``ckpt_state``,
    packed by ``pack_shard``) laid out as the manager saves it, restored
    into ``device`` memory by ``restore_shard_device`` on a
    ``LocalClient``: (a) healthy, twice (the second reported); (b) with one
    byte flipped in one hot replica of one block (re-read, no fallback);
    (c) with every hot replica of that block corrupted and shards 0 and 3 of
    every cold-copy block missing (the whole shard from the cold copy, every
    block rebuilt on the device). Raises on any difference; the stores are
    removed at the end."""
    root = Path(workdir) if workdir is not None else REPO / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_restore_", dir=root))
    try:
        t0 = time.perf_counter()
        tree = ckpt_state(params, seed + 3, device)
        payload, specs = pack_shard(tree)
        crc = crc32c(payload)  # as CheckpointManager.save_shard computes it
        pack_s = time.perf_counter() - t0
        base = "/smoke/ckpt"
        hot = ckptpaths.shard_data_path(base, 1, 0)
        cold = ckptpaths.shard_ec_path(base, 1, 0)
        t0 = time.perf_counter()
        stores, metas = lay_out_shard(
            tmp, np.frombuffer(payload, dtype=np.uint8),
            block_size=block_size, hot=hot, cold=cold)
        setup_s = time.perf_counter() - t0
        spec = {"shard": 0, "path": hot, "ec_path": cold,
                "size": len(payload), "crc32c": crc,
                "tensors": [t.to_dict() for t in specs]}
        del payload
        client = LocalClient(stores, metas)
        reader = HbmReader(client, [device])
        blocks = metas[hot]["blocks"]
        mid = blocks[len(blocks) // 2]
        reset_launches()
        runs = [asyncio.run(_restore_run(reader, client, spec, device, tree))
                for _ in range(2)]
        _flip_first_replica(client, mid)
        try:
            flipped = asyncio.run(_restore_run(reader, client, spec, device,
                                               tree))
        finally:
            _flip_first_replica(client, mid)
        if flipped["rereads"] != 1 or flipped["degraded_shard_reads"]:
            raise AssertionError(f"restore with a flipped replica: {flipped}")
        for replica in range(3):
            _flip_first_replica(client, mid, replica)
        _drop_shards(client, metas[cold], CKPT_LOST)
        degraded = asyncio.run(_restore_run(reader, client, spec, device,
                                            tree))
        rebuilt = degraded["launches"]["gf256_matmul"]
        if degraded["degraded_shard_reads"] != 1 or \
                rebuilt != len(blocks) * (device.type == "cuda"):
            raise AssertionError(f"degraded restore: {degraded}")
        counts = launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    reduced = [] if params == CKPT_PARAMS else [
        f"params_per_rank {params} of {CKPT_PARAMS}"]
    if block_size != 64 * MiB:
        reduced.append(f"block_size {block_size} of {64 * MiB}")
    return {"phase": "restore", "device": str(device), "seed": seed,
            "shard": "Llama-2-7B (6.74e9 params) fp32 weights + Adam m, v "
                     "(12 B/param), 1 of 64 data-parallel ranks",
            "states": "flat: params, adam_m, adam_v one tensor each",
            "params_per_rank": params, "reduced": reduced,
            "tensors": {t["name"]: [t["dtype"], t["shape"]] for t in
                        spec["tensors"]},
            "payload_bytes": spec["size"], "block_size": block_size,
            "blocks": len(blocks), "tail_block_bytes": blocks[-1]["size"],
            "hot_replicas": 3, "ec": list(CKPT_EC), "ec_lost": list(CKPT_LOST),
            "pack_s": pack_s, "setup_s": setup_s, **runs[1],
            "first_run": runs[0], "flipped": flipped, "degraded": degraded,
            "degraded_gbps": degraded["gbps"], "exact": True,
            "launches": counts}


# ------------------------------------------------------- phase: dataset

#: nanoGPT's GPT-2 pretraining read (``config/train_gpt2.py``): blocks of
#: 1,024 tokens in batches of 12, tokens stored as uint16 as in its
#: ``train.bin``; one record is one block, 2,048 bytes.
GPT2_BLOCK_TOKENS = 1024
GPT2_BATCH = 12
GPT2_VOCAB = 50257


def dataset_path(device: torch.device, *, file_bytes: int = 1 << 30,
                 block_size: int = 64 * MiB, batches: int = 300,
                 seed: int = 0, num_workers: int = 2,
                 workdir: Path | None = None) -> dict:
    """The ``dataset`` phase: a 3x-replicated file of uint16 GPT-2 tokens
    read as 2,048-byte records through ``DfsRecordSource`` on a
    ``LocalClient``, ``make_dataset(batch_size=12, shuffle_seed=seed)``
    (``num_workers`` spawned loader workers) and ``device_iterator`` onto
    ``device``, for ``batches`` batches; then every landed batch checked
    against the source records of the sampler's order. The rates count the
    batches after the first (which pays the workers' start)."""
    root = Path(workdir) if workdir is not None else REPO / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dataset_", dir=root))
    try:
        t0 = time.perf_counter()
        tokens = np.random.default_rng(seed + 4).integers(
            0, GPT2_VOCAB, file_bytes // 2, dtype=np.uint16)
        addrs, stores, handles = _stores(tmp, 3)
        path = "/smoke/tokens"
        metas = {path: _write_replicated(handles, addrs, path,
                                        tokens.view(np.uint8), block_size)}
        setup_s = time.perf_counter() - t0
        record = GPT2_BLOCK_TOKENS * tokens.itemsize
        source = DfsRecordSource(functools.partial(LocalClient, stores, metas),
                                 [path], record, dtype="uint16")
        try:
            loader = make_dataset(
                source, batch_size=GPT2_BATCH, shuffle_seed=seed,
                device=device, num_workers=num_workers)
            landed, first_s = [], None
            it = device_iterator(loader, device)
            sync(device)
            t0 = time.perf_counter()
            try:
                for batch in it:
                    landed.append(batch)
                    if first_s is None:
                        sync(device)
                        first_s = time.perf_counter() - t0
                    if len(landed) == batches:
                        break
            finally:
                it.close()
            sync(device)
            seconds = time.perf_counter() - t0
            nrecords = len(source)
        finally:
            source.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if len(landed) != batches:
        raise AssertionError(f"dataset: {len(landed)} of {batches} batches")
    order = EpochSampler(nrecords, seed=seed)
    want_idx = np.fromiter(order, dtype=np.int64,
                           count=nrecords)[: batches * GPT2_BATCH]
    records = tokens.reshape(-1, GPT2_BLOCK_TOKENS)
    for i, batch in enumerate(landed):
        want = records[want_idx[i * GPT2_BATCH : (i + 1) * GPT2_BATCH]]
        if batch.device != device or batch.dtype != torch.uint16 or \
                not np.array_equal(batch.cpu().numpy(), want):
            raise AssertionError(f"dataset: batch {i} differs")
    steady = seconds - first_s
    steady_records = (batches - 1) * GPT2_BATCH
    return {"phase": "dataset", "device": str(device), "seed": seed,
            "source": "nanoGPT config/train_gpt2.py: block_size 1024, "
                      "batch_size 12, uint16 tokens",
            "file_bytes": file_bytes, "block_size": block_size,
            "record_bytes": record, "records": nrecords,
            "batch_size": GPT2_BATCH, "batches": batches,
            "num_workers": num_workers, "setup_s": setup_s,
            "first_batch_s": first_s, "seconds": seconds,
            "records_per_s": steady_records / steady,
            "gbps": steady_records * record / steady / 1e9, "exact": True}


# ---------------------------------------------------------- card phases


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _build() -> dict:
    """nvcc for each kernel source and g++ for the block I/O library, all
    started together."""
    from concurrent.futures import ThreadPoolExecutor

    from tpudfs_torch.gpu import kernels

    def build_native() -> tuple[Path, float]:
        t0 = time.perf_counter()
        return native.build(), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        blockio = pool.submit(build_native)
        info = kernels.build()
        so, gxx_s = blockio.result()
    for name in info:
        kernels.lib(name)
    native.lib()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "blockio": {"so": str(so.relative_to(REPO)), "gxx_s": gxx_s},
            "kernels": {
                name: {"so": str(Path(i["so"]).relative_to(REPO)),
                       "nvcc_s": i["seconds"],
                       "ptxas": [ln.strip() for ln in i["ptxas"].splitlines()
                                 if "registers" in ln or "spill" in ln
                                 or "Function properties" in ln]}
                for name, i in info.items()}}


def _gf_cases() -> list[tuple]:
    """(label, (rows, cols, 8) bit-planes or a (rows, cols) matrix, as host
    arrays) for kernel checks: RS(6,3) and RS(4,2) encode, RS(6,3) decode for
    three erasure patterns, RS(10,4) decode, and a one-row matrix."""
    cases = [("encode_6_3", coef_bits(6, 3)), ("encode_4_2", coef_bits(4, 2))]
    for k, m, lost in ((6, 3, (0, 2, 7)), (6, 3, (1, 4)), (6, 3, (6, 7, 8)),
                       (10, 4, (0, 3, 11, 13))):
        present = tuple(i for i in range(k + m) if i not in lost)
        cases.append((f"decode_{k}_{m}_lost_{'_'.join(map(str, lost))}",
                      decode_matrix(k, m, present)))
    cases.append(("one_row_6", coef_bits(6, 3)[:1]))
    return cases


def _kernels_vs_plain(device: torch.device, rng) -> dict:
    wcontrib = host_to_device(word_contrib_table(), device)
    crc = {}
    for c in (1, 255, 257, 131072):
        words = _random_words(rng, (c, 128), device)
        err = _same(crc32c_chunks_device(words),
                    crc32c_chunks_plain(words, wcontrib, inv_contrib()))
        if err:
            raise AssertionError(f"crc32c_chunks differs at C={c}: {err}")
        crc[str(c)] = err
    blocks = {}
    for cpb in (1, 257, 131072):
        for nblocks in (1, 3, 4, 16):
            words = _device_words(rng, (nblocks * cpb, 128), device)
            err = _same(crc32c_blocks_device(words, nblocks),
                        crc32c_blocks_plain(words, nblocks, wcontrib,
                                            inv_contrib(),
                                            fold_table_device(cpb, device)))
            if err:
                raise AssertionError(
                    f"crc32c_blocks differs at cpb={cpb} x {nblocks}: {err}")
            blocks[f"{cpb}x{nblocks}"] = err
    gf = {}
    for label, mat in _gf_cases():
        coefs = matrix_bits_device(mat, device) if mat.ndim == 2 \
            else host_to_device(mat, device)
        for w in (32, 2047, 2_796_224):
            words = _random_words(rng, (coefs.shape[1], w), device)
            err = _same(gf_matmul_words(words, coefs), gf_rows_plain(words, coefs))
            if err:
                raise AssertionError(f"gf256 {label} differs at W={w}: {err}")
            gf[f"{label}/W={w}"] = err
    sync(device)
    return {"phase": "kernels_vs_plain", "exact": True,
            "crc32c_chunks": crc, "crc32c_blocks": blocks,
            "gf256_matmul": gf}


def _time_ms(fn, device, held: bool = True, **runs) -> float:
    """Device time of one call (``kernels.time_ms``, which ``runs`` passes
    ``runs``/``warmup`` to); ``held=False`` times single calls, the host's
    launch latency included."""
    from tpudfs_torch.gpu import kernels

    with torch.cuda.device(device):
        return kernels.time_ms(fn, held=held, **runs)


def _blocks_bytes(c: int, nblocks: int) -> int:
    """Bytes the fused CRC must move for ``nblocks`` blocks of ``c`` chunks:
    the words, WCONTRIB, the operator rows it reads (M^0..M^31 and one
    M^(32*2^q) per bit of the last tile index), one output word each."""
    return (nblocks * c * 512 + 32 * 128 * 4
            + (32 + (-(-c // 32) - 1).bit_length()) * 32 * 4 + 4 * nblocks)


def _kernel_times(device: torch.device, rng, counts: dict,
                  block_size: int) -> tuple[dict, list]:
    """Kernel and plain times at the main path's shapes: one 64 MiB block's
    chunk CRCs and whole-block CRC, and RS(6,3) decode (plus encode) of one
    64 MiB block."""
    c = block_size // CHECKSUM_CHUNK_SIZE
    words = _random_words(rng, (c, 128), device)
    wcontrib = host_to_device(word_contrib_table(), device)
    crc_ms = _time_ms(lambda: crc32c_chunks_device(words), device)
    crc_call = _time_ms(lambda: crc32c_chunks_device(words), device, False)
    crc_plain = _time_ms(lambda: crc32c_chunks_plain(words, wcontrib,
                                                     inv_contrib()), device)
    crc_err = _same(crc32c_chunks_device(words),
                    crc32c_chunks_plain(words, wcontrib, inv_contrib()))
    crc_bytes = c * 512 + 32 * 128 * 4 + c * 4
    fold = fold_table_device(c, device)
    block_crc_ms = _time_ms(lambda: block_crc_device(words), device)
    block_crc_call = _time_ms(lambda: block_crc_device(words), device, False)
    blocks_plain = _time_ms(lambda: crc32c_blocks_plain(
        words, 1, wcontrib, inv_contrib(), fold), device)
    blocks_err = _same(block_crc_device(words).reshape(1),
                       crc32c_blocks_plain(words, 1, wcontrib, inv_contrib(),
                                           fold))

    # The combiner's round: COMBINED_BATCH blocks in one launch.
    nb = COMBINED_BATCH
    round_words = _device_words(rng, (nb * c, 128), device)
    round_ms = _time_ms(lambda: crc32c_blocks_device(round_words, nb), device)
    round_call = _time_ms(lambda: crc32c_blocks_device(round_words, nb),
                          device, False)
    round_plain = _time_ms(lambda: crc32c_blocks_plain(
        round_words, nb, wcontrib, inv_contrib(), fold), device)
    round_err = _same(crc32c_blocks_device(round_words, nb),
                      crc32c_blocks_plain(round_words, nb, wcontrib,
                                          inv_contrib(), fold))
    del round_words

    slen = -(-block_size // 6)
    w = -(-slen // 128) * 128 // 4  # padded shard words (2,796,224 at 64 MiB)
    present = (1, 3, 4, 5, 6, 8)  # shards 0, 2, 7 lost
    dec = matrix_bits_device(decode_matrix(6, 3, present), device)
    enc = host_to_device(coef_bits(6, 3), device)
    shards = _random_words(rng, (6, w), device)
    dec_ms = _time_ms(lambda: gf_matmul_words(shards, dec), device)
    dec_call = _time_ms(lambda: gf_matmul_words(shards, dec), device, False)
    dec_plain = _time_ms(lambda: gf_rows_plain(shards, dec), device)
    enc_ms = _time_ms(lambda: gf_matmul_words(shards, enc), device)
    enc_call = _time_ms(lambda: gf_matmul_words(shards, enc), device, False)
    enc_plain = _time_ms(lambda: gf_rows_plain(shards, enc), device)
    dec_err = _same(gf_matmul_words(shards, dec), gf_rows_plain(shards, dec))
    dec_bytes = 6 * w * 4 * 2 + dec.numel() * 4
    enc_bytes = 6 * w * 4 + 3 * w * 4 + enc.numel() * 4

    def bound(nbytes: int) -> float:
        return nbytes / HBM_BYTES_PER_S * 1e3

    phase = {
        "phase": "kernel_times", "runs": 25, "stat": "median",
        "timer": "cuda events; ms: stream held, 10 calls back to back; "
                 "call_ms: one call, the host's launch latency included",
        "bound_rate": "3.35 TB/s HBM (H100 SXM)",
        "crc32c_chunks": {"chunks": c, "ms": crc_ms, "call_ms": crc_call,
                          "plain_ms": crc_plain, "bound_ms": bound(crc_bytes)},
        "crc32c_blocks": {"chunks": c, "nblocks": 1,
                          "block_crc_ms": block_crc_ms,
                          "call_ms": block_crc_call, "plain_ms": blocks_plain,
                          "bound_ms": bound(_blocks_bytes(c, 1))},
        f"crc32c_blocks_{nb}x": {"chunks": nb * c, "nblocks": nb,
                                 "ms": round_ms, "call_ms": round_call,
                                 "plain_ms": round_plain,
                                 "bound_ms": bound(_blocks_bytes(c, nb))},
        "gf256_decode_6_3": {"words": w, "ms": dec_ms, "call_ms": dec_call,
                             "plain_ms": dec_plain, "bound_ms": bound(dec_bytes)},
        "gf256_encode_6_3": {"words": w, "ms": enc_ms, "call_ms": enc_call,
                             "plain_ms": enc_plain, "bound_ms": bound(enc_bytes)},
        "library_ms": None, "library_reason": NO_LIBRARY,
        "bound_by": "bytes (no published integer-ALU peak)",
    }
    table = [
        {"name": "crc32c_chunks", "launches": counts["crc32c_chunks"],
         "max_abs_err": crc_err, "ms": crc_ms, "plain_ms": crc_plain,
         "bound_ms": bound(crc_bytes)},
        {"name": "crc32c_blocks", "launches": counts["crc32c_blocks"],
         "max_abs_err": blocks_err, "ms": block_crc_ms,
         "plain_ms": blocks_plain, "bound_ms": bound(_blocks_bytes(c, 1)),
         # The combiner's shape (the row's own numbers are one block's).
         f"at_{nb}_blocks": {"max_abs_err": round_err, "ms": round_ms,
                             "plain_ms": round_plain,
                             "bound_ms": bound(_blocks_bytes(c, nb))}},
        {"name": "gf256_matmul", "launches": counts["gf256_matmul"],
         "max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain,
         "bound_ms": bound(dec_bytes)},
    ]
    for row in table:
        k = KERNELS[row["name"]]
        row.update(route=k["route"], source=k["source"], replaces=k["replaces"],
                   bound_by="bytes", library_ms=None)
    return phase, table


def _timed_row(device, fn, plain, nbytes: int, launches: int,
               **shape) -> dict:
    """Kernel ``fn`` against its plain twin ``plain`` at one shape: device
    time (stream held), one call, the plain twin's time (single calls, 3
    runs: it takes tenths of a second at these shapes), the largest
    difference (any raises: the kernels are exact) and the byte bound."""
    err = _same(fn(), plain())
    if err:
        raise AssertionError(f"kernel differs from its plain twin at {shape}: "
                             f"{err}")
    return {**shape, "launches": launches, "max_abs_err": err,
            "ms": _time_ms(fn, device), "call_ms": _time_ms(fn, device, False),
            "plain_ms": _time_ms(plain, device, False, runs=3, warmup=1),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def _write_kernel_times(device, rng, by_path, write, ec, phase, table) -> None:
    """Both kernels at the write side's shapes, added to the kernel_times
    phase and, nested by shape, to the table's rows: the chunk CRCs of one
    write position's verify launch (R replica groups of B blocks), the
    RS(k,m) encode of one scatter position (k rows in, m out, at the
    scatter's 512-byte shard width), and the gather's (k, k+m) runtime
    decode matrix. The decode's bound counts the 2k rows the function
    needs (k survivors in, k rows out): the matrix's zero column adds
    nothing to the output. The kernel reads all k+m rows, zero column
    included; those bytes are reported beside it, not in the bound."""
    c = write["replication"] * write["blocks_per_position"] \
        * (write["block_size"] // CHECKSUM_CHUNK_SIZE)
    words = _device_words(rng, (c, 128), device)
    wcontrib = host_to_device(word_contrib_table(), device)
    crc = _timed_row(
        device, lambda: crc32c_chunks_device(words),
        lambda: crc32c_chunks_plain(words, wcontrib, inv_contrib()),
        c * 512 + 32 * 128 * 4 + c * 4,
        by_path["write"]["crc32c_chunks"], chunks=c)
    del words
    k, m = ec["ec"]
    w = ec["shard_bytes"] // 4
    shards = _device_words(rng, (k + m, w), device)
    enc = host_to_device(coef_bits(k, m), device)
    dec = matrix_bits_device(decode_select_matrices(
        k, m, k + m, k + m, ec["gather_failed"])[0], device)
    gf_launches = ec["gf256_launches"]
    data = shards[:k]
    encode_row = _timed_row(
        device, lambda: gf_matmul_words(data, enc),
        lambda: gf_rows_plain(data, enc),
        (k + m) * w * 4 + enc.numel() * 4, gf_launches["encode"], words=w,
        matrix=[m, k])
    decode_row = _timed_row(
        device, lambda: gf_matmul_words(shards, dec),
        lambda: gf_rows_plain(shards, dec),
        2 * k * w * 4 + dec.numel() * 4, gf_launches["decode"], words=w,
        matrix=[k, k + m])
    decode_row["bytes_read_by_design"] = (k + m + k) * w * 4 + dec.numel() * 4
    phase["crc32c_chunks_write_verify"] = crc
    phase[f"gf256_scatter_encode_{k}_{m}"] = encode_row
    phase[f"gf256_gather_decode_{k}_{k + m}"] = decode_row
    rows = {row["name"]: row for row in table}
    rows["crc32c_chunks"]["at_write_verify"] = crc
    rows["gf256_matmul"]["at_scatter_encode"] = encode_row
    rows["gf256_matmul"]["at_gather_decode"] = decode_row


def _restore_kernel_times(device, rng, restore, phase, table) -> None:
    """Both kernels at the restore's shapes, added to the kernel_times
    phase and, nested, to the table's rows, each with the restore's
    launches: the fused CRC of one block (one eager launch a full block)
    and the RS(k,m) decode that rebuilds one cold-copy block from k
    survivors (a (k, k) matrix at one block's padded shard width; its bound
    counts k rows in and k out)."""
    c = restore["block_size"] // CHECKSUM_CHUNK_SIZE
    words = _device_words(rng, (c, 128), device)
    wcontrib = host_to_device(word_contrib_table(), device)
    fold = fold_table_device(c, device)
    crc = _timed_row(
        device, lambda: crc32c_blocks_device(words, 1),
        lambda: crc32c_blocks_plain(words, 1, wcontrib, inv_contrib(), fold),
        _blocks_bytes(c, 1), restore["launches"]["crc32c_blocks"], chunks=c,
        nblocks=1)
    del words
    k, m = restore["ec"]
    w = pad_shard_len(-(-restore["block_size"] // k)) // 4
    present = tuple(i for i in range(k + m) if i not in restore["ec_lost"])
    dec = matrix_bits_device(decode_matrix(k, m, present), device)
    shards = _device_words(rng, (k, w), device)
    decode = _timed_row(
        device, lambda: gf_matmul_words(shards, dec),
        lambda: gf_rows_plain(shards, dec), 2 * k * w * 4 + dec.numel() * 4,
        restore["launches"]["gf256_matmul"], words=w, matrix=[k, k])
    phase["crc32c_blocks_restore"] = crc
    phase[f"gf256_restore_decode_{k}_{m}"] = decode
    rows = {row["name"]: row for row in table}
    rows["crc32c_blocks"]["at_restore_block"] = crc
    rows["gf256_matmul"]["at_restore_decode"] = decode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(_nvidia_smi(), flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})
    emit(_build())
    rng = np.random.default_rng(args.seed)
    emit(_kernels_vs_plain(device, rng))
    result = read_path(device, seed=args.seed)
    ec_rebuild = result.pop("ec_rebuild")
    batched = [result.pop(name) for name in ("combined", "sweep", "infeed")]
    emit(result)
    emit(ec_rebuild)
    for phase in batched:
        emit(phase)
    write = write_path(device, seed=args.seed)
    emit(write)
    ec = ec_collective(device, seed=args.seed)
    emit(ec)
    restore = restore_path(device, seed=args.seed)
    emit(restore)
    dataset = _counted(lambda: dataset_path(device, seed=args.seed))
    emit(dataset)
    by_path = {"read_path": result["launches"],
               **{p["phase"]: p["launches"]
                  for p in batched + [write, ec, restore, dataset]}}
    for path, counts in by_path.items():
        never = [k for k in PATH_KERNELS[path] if not counts[k]]
        if never:
            raise AssertionError(f"{path}: kernels never launched: {never}")
    counts = {name: sum(c[name] for c in by_path.values()) for name in KERNELS}
    phase, table = _kernel_times(device, rng, counts, result["block_size"])
    _write_kernel_times(device, rng, by_path, write, ec, phase, table)
    _restore_kernel_times(device, rng, restore, phase, table)
    emit(phase)
    emit({"phase": "kernels", "launches": counts, "by_path": by_path})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
