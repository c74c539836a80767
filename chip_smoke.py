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
``ec_rebuild``, ``combined``, ``sweep``, ``infeed``, ``kernel_times``,
``kernels``), the kernel table ``{"kernels": [...]}``, and last
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

Data is made from ``--seed`` with numpy.
"""

from __future__ import annotations

import argparse
import asyncio
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
from tpudfs_torch.common import native
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c_chunks, crc32c_fold
from tpudfs_torch.common.erasure import encode
from tpudfs_torch.gpu import host_to_device, u32_to_i64
from tpudfs_torch.gpu.crc32c_cuda import (
    block_crc_device,
    crc32c_blocks_device,
    crc32c_blocks_plain,
    crc32c_chunks_device,
    crc32c_chunks_plain,
    fold_table_device,
    inv_contrib,
    word_contrib_table,
)
from tpudfs_torch.gpu.hbm_reader import HbmReader, device_array_to_bytes
from tpudfs_torch.gpu.infeed import DfsInfeed
from tpudfs_torch.gpu.rs_cuda import (
    coef_bits,
    decode_matrix,
    gf_matmul_words,
    gf_rows_plain,
    matrix_bits_device,
    pad_shard_len,
    rs_decode_device,
)

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
#: block and the tampered slot); the infeed reads per block, eagerly.
PATH_KERNELS = {
    "read_path": ("crc32c_chunks", "crc32c_blocks", "gf256_matmul"),
    "combined": ("crc32c_blocks",),
    "sweep": ("crc32c_chunks", "crc32c_blocks"),
    "infeed": ("crc32c_chunks", "crc32c_blocks"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def launches() -> dict[str, int]:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def sync(device: torch.device) -> None:
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


def lay_out(workdir: Path, rng, *, block_size: int, nblocks: int,
            tail_size: int, ec: tuple, lost: tuple) -> tuple:
    """Stores in the chunkserver's format + GetFileInfo-shaped metas.
    Returns (stores, metas, sources): ``sources[path]`` is the file's bytes."""
    k, m = ec
    addrs = [f"cs{i}:7000" for i in range(max(3, k + m))]
    stores = {a: (workdir / f"cs{i}" / "hot", None) for i, a in enumerate(addrs)}
    handles = {a: BlockStore(hot, cold) for a, (hot, cold) in stores.items()}
    metas, sources = {}, {}

    def replicated(path: str, data) -> None:
        blocks = []
        for i, off in enumerate(range(0, len(data), block_size)):
            piece = data[off : off + block_size]
            sums = crc32c_chunks(piece)
            bid = f"blk_{path.strip('/').replace('/', '_')}_{i}"
            locs = [addrs[(i + r) % 3] for r in range(3)]
            for a in locs:
                handles[a].write(bid, piece, sums)
            blocks.append(_block_meta(bid, len(piece), locs,
                                      crc32c_fold(sums, len(piece),
                                                  CHECKSUM_CHUNK_SIZE)))
        metas[path] = {"path": path, "size": len(data), "blocks": blocks}
        sources[path] = data

    replicated("/smoke/big", np.frombuffer(rng.bytes(nblocks * block_size),
                                           dtype=np.uint8))
    replicated("/smoke/tail", np.frombuffer(rng.bytes(tail_size), dtype=np.uint8))
    ecdata = rng.bytes(block_size)
    shards = encode(ecdata, k, m)
    for i, shard in enumerate(shards):
        if i not in lost:
            handles[addrs[i]].write("blk_smoke_ec_0", shard)
    crc = crc32c_fold(crc32c_chunks(ecdata), block_size, CHECKSUM_CHUNK_SIZE)
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


def _flip_first_replica(client: LocalClient, block: dict) -> None:
    """Flip one byte of the block's first replica (a second call undoes it)."""
    store = client._local_stores[block["locations"][0]][0]
    with open(store.block_path(block["block_id"]), "r+b") as f:
        f.seek(12345)
        byte = f.read(1)
        f.seek(12345)
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


def _time_ms(fn, device, held: bool = True) -> float:
    """Device time of one call (``kernels.time_ms``); ``held=False`` times
    single calls, the host's launch latency included."""
    from tpudfs_torch.gpu import kernels

    with torch.cuda.device(device):
        return kernels.time_ms(fn, held=held)


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
    # Words, WCONTRIB, the operator rows the kernel reads (M^0..M^31 and
    # one M^(32*2^q) per bit of the last tile index), one output word each.
    def blocks_bytes(nblocks: int) -> int:
        return (nblocks * c * 512 + 32 * 128 * 4
                + (32 + (-(-c // 32) - 1).bit_length()) * 32 * 4 + 4 * nblocks)

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
                          "bound_ms": bound(blocks_bytes(1))},
        f"crc32c_blocks_{nb}x": {"chunks": nb * c, "nblocks": nb,
                                 "ms": round_ms, "call_ms": round_call,
                                 "plain_ms": round_plain,
                                 "bound_ms": bound(blocks_bytes(nb))},
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
         "plain_ms": blocks_plain, "bound_ms": bound(blocks_bytes(1)),
         # The combiner's shape (the row's own numbers are one block's).
         f"at_{nb}_blocks": {"max_abs_err": round_err, "ms": round_ms,
                             "plain_ms": round_plain,
                             "bound_ms": bound(blocks_bytes(nb))}},
        {"name": "gf256_matmul", "launches": counts["gf256_matmul"],
         "max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain,
         "bound_ms": bound(dec_bytes)},
    ]
    for row in table:
        k = KERNELS[row["name"]]
        row.update(route=k["route"], source=k["source"], replaces=k["replaces"],
                   bound_by="bytes", library_ms=None)
    return phase, table


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
    by_path = {"read_path": result["launches"],
               **{p["phase"]: p["launches"] for p in batched}}
    for path, counts in by_path.items():
        never = [k for k in PATH_KERNELS[path] if not counts[k]]
        if never:
            raise AssertionError(f"{path}: kernels never launched: {never}")
    counts = {name: sum(c[name] for c in by_path.values()) for name in KERNELS}
    phase, table = _kernel_times(device, rng, counts, result["block_size"])
    emit(phase)
    emit({"phase": "kernels", "launches": counts, "by_path": by_path})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
