#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        # needs one CUDA card; exits 1 without one

Builds the hand-written kernels from ``tpudfs_torch/gpu/csrc`` with nvcc
(and the native host engine from ``native/`` with g++), holds each kernel
entry (per-chunk CRC32C, fused whole-block CRC32C, GF(2^8) matrix product)
against its plain PyTorch twin on the card, drives the verified read into
device memory at real size (the port's main path), times each entry at the
main path's shapes, and checks every byte that comes out.

Output (stdout): the card's ``nvidia-smi`` name and power limit, one JSON
line per phase (``device``, ``build``, ``kernels_vs_plain``,
``host_engine``, ``read_path``,
``ec_rebuild``, ``combined``, ``sweep``, ``infeed``, ``write``,
``ec_collective``, ``entry``, ``dryrun``, ``restore``, ``cluster``,
``sharded``, ``dataset``, ``bench``, ``kernel_times``, ``kernels``), the
kernel table
``{"kernels": [...]}`` (each row at the read path's shape, with the write
side's shapes nested in it), and last
``{"ok": true, "device": {...}}``. Any mismatch raises: the run exits
non-zero and prints no result.

``host_engine``: the native host engine (``common/native.py``) over one
seeded 64 MiB buffer: ``crc32c``, ``crc32c_chunks`` at 512 bytes, RS(3,2)
and RS(6,3) ``encode`` and a ``decode`` of each with m shards lost, every
result bit-exact with its numpy twin, each timed native and plain. Each
phase after it reports the engine's calls (``engine_calls``, counted from
0 just before it), and a phase that must use the engine fails without
them (``PATH_ENGINE``).

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
  stores on local disk; every position writes 4 blocks of 64 MiB at once
  (one round of B=4) through its member's ``_try_ici_write``, the hook a
  chunkserver serves a chain write with, twice, every response a success
  with 3 replicas; then one tampered round (a poisoned expected CRC) that
  must fail as a whole, answer None (the TCP fallback) for every block,
  count one fallback each and persist nothing;
- ``ec_collective``: RS(6,3) scatter and gather of one 64 MiB block per
  position over a 9-position ring, the gather healthy and around position
  4 with its rows overwritten; and ``replicated_write_step(ec=(6,3))`` on
  the 3-ring against the host encoder.

Then the entry points of ``tpudfs_torch.graft_entry``, each phase
with the launch counts reset just before it and read just after:

- ``entry``: ``entry(chunks=131_076)``'s step, one 64 MiB block (the
  smallest multiple of 6 chunks that holds it): its chunk CRCs against the
  expected ones, its RS(6,3) parity against the host encoder, one write
  ack from the 1-position ring; one call with a poisoned expected CRC must
  fail ``crc_ok`` and ``write_ok``; then the step's time;
- ``dryrun``: ``dryrun_multichip(8)`` and ``dryrun_multichip(9)`` at one
  64 MiB block a position (the data made on the device): the replicated
  write step with RS(6,3) parity, the RS(5,3) / RS(6,3) scatter and the
  degraded gather around position 0 with its shards garbage (every
  position's words back bit-exact), and the 2x4 / 3x3 ``(dcn, ici)`` pod
  leg's chain and scatter, each leg timed; one more run of each size
  under ``torch.profiler`` gives each leg's device-busy share from its
  trace. The live collective-write leg needs the reference's chunkserver
  and master, which this script may not import: the CPU tests and
  ``tests/test_torch_cuda.py`` run it.

Then the training job's two reads:

- ``restore``: one data-parallel rank's checkpoint shard at real size
  (Llama-2-7B's mixed-precision state over 64 ranks: bf16 weights beside
  the fp32 master weights and Adam moments, 1.474 GB, 22 blocks of 64 MiB;
  the bf16 tensor is a view checked by its own CRC), packed by the port's
  ``pack_shard`` and laid out as
  the checkpoint manager saves it (a 3x-replicated hot copy and an RS(3,2)
  cold copy), restored into device memory by ``restore_shard_device``:
  healthy twice, with one byte flipped in one hot replica, and with one
  block's every hot replica corrupt and shards 0 and 3 of every cold-copy
  block missing (every block rebuilt on the card); every tensor bit-exact;
  the time of the tensors that are not 4-byte words split into their
  views and their own CRCs (``bounce_copy``, ``bounce_crc``), the bytes
  so checked (``tensor_counts``; one fused-CRC launch a tensor, beside one
  a full block), the layout's into the hot copy, the
  EC encode and the EC writes (``setup_split_s``);
- ``dataset``: GPT-2 pretraining records (nanoGPT's block of 1,024 uint16
  tokens, batches of 12) from a 1 GiB 3x-replicated file through
  ``DfsRecordSource``, ``make_dataset`` and ``device_iterator``, a few
  hundred batches, each checked against the source.

Then the live cluster:

- ``cluster``: 1 master and 5 chunkservers, each an OS process started
  by the port's launcher (``tpudfs_torch.cluster``: the system's own
  servers by module name, the chunkservers' block cache off), driven
  through the port's own client (``tpudfs_torch.client.client``, 64 MiB
  blocks, CRC-64 ETags) over the wire: a 1 GiB file of 16 x 64 MiB
  blocks and the 1,000,003-byte file written at 3x, a 4-block RS(3,2)
  file (write GB/s each); the three read paths into ``cuda:0`` (per
  block with lazy verify and one ``confirm``, the combiner in rounds of
  4, the sweep pump), once with every byte over the blockport and once
  short-circuited off the chunkservers' disks, each checked byte for
  byte; one flipped byte in one replica read each way (the device CRC
  catches it on the short circuit, the chunkserver's sidecar verify over
  the wire) and recovered; two of the chunkservers that hold data shards
  of the EC file's first block SIGKILLed, and the EC file read back
  bit-exact over the wire, every block that lost a data shard rebuilt
  with at least one ``gf256_matmul`` launch. The process then holds no
  module of the JAX package or of JAX.
- ``sharded``: the Helm chart's deployment (``deploy/helm/tpudfs``:
  3 config servers in one Raft group, shards ``shard-a`` and ``shard-z``
  of 3 masters each, one spare group of 3 masters, 5 chunkservers in 3
  racks, the masters' split threshold at 100 requests a second) with TLS
  on every transport (``tpudfs_torch.cluster.HelmCluster``, the
  chunkservers' block cache off, every blockport the native engine),
  driven through the port's client as the chart's users build it (the
  config servers alone, ``ClientTls``, no local short circuit, 64 MiB
  blocks, the chunkservers' scrubber at the chart's 60 s): a 1 MiB
  probe file no restore reads written at 3x, one byte flipped in one
  replica, which the scrubber must report in its log by the phase's end;
  the ``dataset`` phase's 1 GiB token file written at 3x to
  ``/a/staging/`` and renamed across the shards to
  ``/z/train/tokens.bin``; the ``restore`` phase's rank shard saved by
  the port's ``CheckpointManager`` at ``/a/ckpt`` (3x hot copy, RS(3,2)
  cold copy), step 1 healthy and step 2 published through a SIGKILL of
  its shard's leader mid-save (``failover_s``: the kill to the first
  metadata read the new leader answers); ``/`` listed across the shards
  against each shard's own listing; step 2 restored into ``cuda:0``
  bit-exact; a second client sending 150 metadata calls a second on
  ``/a/`` (the other ranks of the job polling) while a third restores
  step 2 back to back, until the masters carve ``/a/`` off to the spare
  group (``split_s``; the new shard must be 3 voters), then step 2
  restored through the phase's first client, whose map predates the
  split, which must follow a ``REDIRECT:``; the token file read through
  the infeed (100 batches, two spawned workers with clients of their
  own) with the owning shard's leader SIGKILLed after the first batch,
  every batch checked; the config group's leader SIGKILLed
  (``config_failover_s``: the kill to the first ``FetchShardMap`` a new
  config leader answers), the two chunkservers holding the most data
  shards of the cold copy SIGKILLed, the hot copy deleted, and step 2
  restored again from the cold copy through a client built from the
  config servers alone, every block that lost a data shard rebuilt by
  one ``gf256_matmul`` launch.

Then the bench:

- ``bench``: ``tpudfs_torch.bench``'s local run at its full constants
  (3 sets of 128 files of one 1 MiB block, 3x replication, laid out in the
  chunkserver's format; raw infeed, the sweep pump's cold and warm
  windows, the write step and the RS(6,3) scatter step on a 1-position
  ring, one confirm), then its two read probes on set 0:
  ``read_profile`` (meta, disk, h2d, full, fused) and five ``sweep_lab``
  cold/warm pairs through the combiner's rounds of 16; then set 0 read
  once more and checked byte for byte. The remote half (writes, creates,
  the gRPC and cache sweeps, against a spawned cluster) is
  ``python3 -m tpudfs_torch.bench``'s default run.

Data is made from ``--seed`` with numpy (and with torch generators on the
card for the checkpoint's state); the bench's bytes from its own seeds.
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

from tpudfs_torch import bench, read_profile, sweep_lab
from tpudfs_torch.ckpt_chaos import (
    PutLog,
    data_shard_holders,
    data_shard_victims,
    is_fault,
    retry_until,
)
from tpudfs_torch.client.local import DfsError, LocalClient, is_error_named
from tpudfs_torch.chunkserver.blockstore import BlockStore
from tpudfs_torch.common import ckptpaths, layout, native, trace
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c, crc32c_fold
from tpudfs_torch.common.erasure import encode
from tpudfs_torch.gpu import host_to_device, u32_to_i64, u32_to_numpy
from tpudfs_torch.gpu.checkpoint import (
    CheckpointManager,
    pack_shard,
    restore_shard_device,
    torch_dtype,
)
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
from tpudfs_torch.graft_entry import (
    device_words,
    dryrun_multichip,
    entry,
    launch_counts,
    positions,
    reconstructed,
    sync,
)
from tpudfs_torch.helm_chaos import (
    first_config_answer,
    log_times,
    prefix_traffic,
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
#: block and the tampered slot); the infeed reads per block, eagerly; the
#: write group verifies every position's replicas with one chunk-CRC
#: launch; the EC collectives encode, CRC the sent and received shards, and
#: decode with runtime matrices; the checkpoint restore verifies every full
#: block with the fused CRC, its unaligned tail block with the chunk CRCs,
#: and rebuilds every cold-copy block with the GF(2^8) decode; the entry
#: step CRCs its batch, verifies its 3 replica groups with one chunk-CRC
#: launch and encodes its parity; the dryrun verifies every replica and
#: every scattered shard with chunk CRCs and encodes, scatters and decodes
#: with the GF(2^8) kernel; the dataset infeed reads records on the host
#: and launches nothing; the bench's probes read through the combiner's
#: fused rounds (and the per-block path's fused CRC), its write step
#: verifies with the chunk CRCs and its scatter encodes with the GF(2^8)
#: kernel; the sharded deployment's restores verify as the restore's do
#: and rebuild every cold-copy block that lost a data shard (its infeed,
#: like the dataset phase's, verifies records on the host).
PATH_KERNELS = {
    "read_path": ("crc32c_chunks", "crc32c_blocks", "gf256_matmul"),
    "combined": ("crc32c_blocks",),
    "sweep": ("crc32c_chunks", "crc32c_blocks"),
    "infeed": ("crc32c_chunks", "crc32c_blocks"),
    "write": ("crc32c_chunks",),
    "ec_collective": ("crc32c_chunks", "gf256_matmul"),
    "entry": ("crc32c_chunks", "gf256_matmul"),
    "dryrun": ("crc32c_chunks", "gf256_matmul"),
    "restore": ("crc32c_blocks", "crc32c_chunks", "gf256_matmul"),
    "dataset": (),
    "bench": ("crc32c_chunks", "crc32c_blocks", "gf256_matmul"),
    "cluster": ("crc32c_blocks", "gf256_matmul"),
    "sharded": ("crc32c_blocks", "crc32c_chunks", "gf256_matmul"),
}
#: The native host engine's entries each phase must call: ``host_engine``
#: its CRC and GF(2^8) entries; the read path lays out its stores with the
#: chunk CRCs and reads the degraded block's shards verified; the write
#: group's members persist every replica with the chunk CRCs and the
#: read-back reads them verified; the restore CRCs the payload and its
#: tail block, and its cold copy is encoded and written with the fused
#: write; the bench
#: lays out its sets with the chunk CRCs and ``read_profile``'s ``disk``
#: stage reads verified.
PATH_ENGINE = {
    "host_engine": ("crc32c", "crc32c_chunks", "gf256_matmul"),
    "read_path": ("crc32c_chunks", "block_read_verify"),
    "write": ("crc32c_chunks", "block_read_verify"),
    "restore": ("crc32c", "gf256_matmul", "block_write"),
    "bench": ("crc32c_chunks", "block_read_verify"),
    "cluster": ("crc32c", "crc64nvme", "gf256_matmul"),
    "sharded": ("crc32c", "crc64nvme", "gf256_matmul"),
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


def _same(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max |a - b| of two uint32 tensors, exact (as int64)."""
    return int((u32_to_i64(a) - u32_to_i64(b)).abs().max().item()) \
        if a.numel() else 0


def _random_words(rng, shape, device) -> torch.Tensor:
    return host_to_device(rng.integers(0, 1 << 32, shape, dtype=np.uint32),
                          device)


# ------------------------------------------------------------ phase: read


def lay_out(workdir: Path, rng, *, block_size: int, nblocks: int,
            tail_size: int, ec: tuple, lost: tuple) -> tuple:
    """Stores in the chunkserver's format + GetFileInfo-shaped metas.
    Returns (stores, metas, sources): ``sources[path]`` is the file's bytes."""
    k, m = ec
    addrs, stores, handles = layout.stores(workdir, max(3, k + m))
    metas, sources = {}, {}
    for path, nbytes in (("/smoke/big", nblocks * block_size),
                         ("/smoke/tail", tail_size)):
        sources[path] = np.frombuffer(rng.bytes(nbytes), dtype=np.uint8)
        metas[path] = layout.write_replicated(handles, addrs, path,
                                              sources[path], block_size)
    ecdata = rng.bytes(block_size)
    shards = encode(ecdata, k, m)
    for i, shard in enumerate(shards):
        if i not in lost:
            handles[addrs[i]].write("blk_smoke_ec_0", shard)
    crc = crc32c_fold(native.crc32c_chunks(ecdata), block_size,
                      CHECKSUM_CHUNK_SIZE)
    metas["/smoke/ec"] = {"path": "/smoke/ec", "size": block_size, "blocks": [
        layout.block_meta("blk_smoke_ec_0", block_size, addrs[: k + m], crc,
                          k=k, m=m)
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
    out["launches"] = launch_counts()
    return out


def _engine_counted(run) -> dict:
    """Run one phase with the host engine's call counts set to 0 just
    before it; the phase's result gains them as ``engine_calls``."""
    native.reset_calls()
    out = run()
    out["engine_calls"] = native.call_counts()
    return out


# ------------------------------------------------------ phase: host_engine

#: The RS codes of the ``host_engine`` phase and the shards each decode
#: loses: the checkpoint's cold copy (``CKPT_EC``, ``CKPT_LOST``) and the
#: read path's degraded block.
ENGINE_CODES = (((3, 2), (0, 3)), ((6, 3), (0, 2, 7)))


def _best_s(fn, reps: int) -> tuple[object, float]:
    """``fn()``'s result and its best wall time of ``reps`` calls."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def host_engine_phase(*, size: int = 64 * MiB, seed: int = 0,
                      reps: int = 3) -> dict:
    """The ``host_engine`` phase: over ``size`` seeded bytes, each entry
    of the native host engine against its numpy twin, bit for bit, with
    both rates (GB/s of input bytes; native the best of ``reps`` calls,
    plain one call). Raises on any difference."""
    from tpudfs_torch.common import checksum, erasure

    data = np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8)
    rows = {}

    def row(name, native_fn, plain_fn, nbytes: int, same) -> None:
        got, native_s = _best_s(native_fn, reps)
        want, plain_s = _best_s(plain_fn, 1)
        if not same(got, want):
            raise AssertionError(f"host_engine: {name} differs from its "
                                 f"plain twin")
        rows[name] = {"bytes": nbytes, "native_gbps": nbytes / native_s / 1e9,
                      "plain_gbps": nbytes / plain_s / 1e9,
                      "native_s": native_s, "plain_s": plain_s}

    def plain_erasure(fn):
        def run():
            erasure._gf_matmul = erasure._gf_matmul_plain
            try:
                return fn()
            finally:
                erasure._gf_matmul = native_matmul
        return run

    native_matmul = erasure._gf_matmul
    row("crc32c", lambda: checksum.crc32c(data),
        lambda: checksum.crc32c_plain(data), size, int.__eq__)
    row("crc32c_chunks_512", lambda: checksum.crc32c_chunks(data),
        lambda: checksum.crc32c_chunks_plain(data), size, np.array_equal)
    raw = data.tobytes()
    for (k, m), lost in ENGINE_CODES:
        enc = (lambda k=k, m=m: erasure.encode(raw, k, m))
        row(f"encode_{k}_{m}", enc, plain_erasure(enc), size, list.__eq__)
        shards = enc()
        for j in lost:
            shards[j] = None
        dec = (lambda k=k, m=m, shards=shards:
               erasure.decode(shards, k, m, size))
        nbytes = k * erasure.shard_len(size, k)
        row(f"decode_{k}_{m}_lost_{'_'.join(map(str, lost))}", dec,
            plain_erasure(dec), nbytes, bytes.__eq__)
        if dec() != raw:
            raise AssertionError(f"host_engine: RS({k},{m}) decode is not "
                                 f"the data")
    return {"phase": "host_engine", "seed": seed, "bytes": size,
            "library": str(native.library_path().relative_to(REPO)),
            "exact": True, "rows": rows}


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
        counts = launch_counts()
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


def _mapping(devices, device: torch.device) -> str:
    """How ring positions map: distinct cards, or all on ``device``."""
    n = len(devices)
    if device.type == "cuda" and len(set(devices)) == n:
        return "distinct cards"
    return f"all {n} positions on {device}"


def ring_devices(device: torch.device, n: int) -> tuple[list, str]:
    """n ring positions (``graft_entry.positions``: distinct cards when
    ``device`` is a card and there are at least n of them, else every
    position on ``device``) and how they map."""
    devices = positions(n, device)
    return devices, _mapping(devices, device)


class StoreMember:
    """A write-group member: an address and a port ``BlockStore`` on local
    disk, persisting each replica with its per-chunk CRCs (the native CRC,
    as a chunkserver's committer computes them). ``attach`` binds the
    chunkserver's hook on it (``_try_ici_write``), which counts its
    fallbacks and invalidates no cache (it keeps none)."""

    ici_fallbacks = 0

    def __init__(self, address: str, root: Path):
        self.address = address
        self.store = BlockStore(root)

    def invalidate_cached(self, block_id: str) -> None:
        pass

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


#: The request fields a chain write carries into the hook.
_WRITE_REQ = {"master_term": 1, "master_shard": "smoke"}


def _hook_write(group, members, p: int, bid: str, data: bytes):
    """One chain write of ``bid`` from ring position ``p``, through its
    member's ``_try_ici_write`` as a chunkserver serves it (the chain is
    the position's ring successors)."""
    return members[p]._try_ici_write(bid, data, _WRITE_REQ,
                                     group.successors(p))


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
            _hook_write(group, members, int(bid.split("_")[2]), bid, d)
            for bid, d in datas.items()))
        sync(*devices)
        seconds = time.perf_counter() - t0
        want = {"success": True, "error_message": "", "replicas_written": n}
        if got != [want] * len(datas) or group.stats.last_acks != n:
            raise AssertionError(f"write pass {tag}: responses {got}, acks "
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
            "tamper": tamper, "host": host, "launches": launch_counts()}


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
    block's hook answering None, the TCP fallback, and counting one
    fallback) and persist nothing."""
    n = len(members)
    real = group.replicator.replicate

    def poisoned(words, crcs):
        crcs = [c.clone() for c in crcs]
        crcs[1].view(torch.int32)[0] ^= 0x5A5A5A5A
        return real(words, crcs)

    failures0 = group.stats.round_failures
    fallbacks0 = [mb.ici_fallbacks for mb in members]
    bids = [f"blk_tamper_{p}" for p in range(n)]
    group.replicator.replicate = poisoned
    try:
        got = await asyncio.gather(
            *(_hook_write(group, members, p, bid, rng.bytes(block_size))
              for p, bid in enumerate(bids)))
    finally:
        group.replicator.replicate = real
    stored = [bid for mb in members for bid in bids
              if mb.store.block_path(bid).exists()]
    fallbacks = [mb.ici_fallbacks - f0
                 for mb, f0 in zip(members, fallbacks0)]
    if (got != [None] * n or fallbacks != [1] * n
            or group.stats.round_failures != failures0 + 1
            or group.stats.last_acks >= n or stored):
        raise AssertionError(f"tampered round did not fail as a whole: {got}, "
                             f"fallbacks {fallbacks}, acks "
                             f"{group.stats.last_acks}, stored {stored}")
    return {"acks": group.stats.last_acks, "round_failures": 1,
            "fallbacks": sum(fallbacks), "persisted": 0}


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
    words = [device_words(rng, (cpb, 128), d) for d in devices]
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
    after_scatter = launch_counts()
    times = {}
    for failed in (None, 4):
        if failed is not None:
            shards[failed].view(torch.int32).fill_(0x25A5A5A5)
        sync(*devices)
        t0 = time.perf_counter()
        recon = gather.gather(shards, failed=failed)
        sync(*devices)
        times[failed] = time.perf_counter() - t0
        bad = [p for p in range(k + m)
               if not reconstructed(recon[p], words[p])]
        if bad:
            raise AssertionError(f"EC gather (failed={failed}): positions "
                                 f"{bad} differ")
    after_gather = launch_counts()
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
    total = launch_counts()
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


# ------------------------------------------------ phases: entry points

#: The entry step at full width: the smallest multiple of 6 chunks that
#: holds one 64 MiB block (the client's default block, ``client.py:55``),
#: so its bytes split into 6 shards of 11,185,152 bytes, a multiple of the
#: GF kernel's 128-byte row.
ENTRY_CHUNKS = 131_076
#: The dryrun: one 64 MiB block a position, on 8 and on 9 positions.
DRYRUN_CHUNKS = 131_072
DRYRUN_SIZES = (8, 9)


def entry_phase(device: torch.device, *, chunks: int = ENTRY_CHUNKS) -> dict:
    """The ``entry`` phase: ``graft_entry.entry``'s step at ``chunks``
    chunks, its chunk CRCs against the expected ones, its parity against
    the host encoder and its one write ack; then one call with a poisoned
    expected CRC, which must fail ``crc_ok`` and ``write_ok``. The launch
    counts are of these two calls; then the step is timed (on a card
    ``kernels.time_ms``: ``step_ms`` with the stream held, ``call_ms`` one
    call)."""
    t0 = time.perf_counter()
    step, (words, crcs) = entry(device, chunks=chunks)
    setup_s = time.perf_counter() - t0
    reset_launches()
    out = step(words, crcs)
    if not (bool(out["crc_ok"]) and bool(out["write_ok"])
            and int(out["write_acks"]) == 1):
        raise AssertionError(f"entry step: crc_ok {bool(out['crc_ok'])}, "
                             f"write_ok {bool(out['write_ok'])}, acks "
                             f"{int(out['write_acks'])}")
    if _same(out["chunk_crcs"], crcs):
        raise AssertionError("entry step: chunk CRCs differ")
    k, m = 6, 3
    want = encode(u32_to_numpy(words).tobytes(), k, m)[k:]
    if not np.array_equal(out["parity"].cpu().numpy(),
                          np.stack([np.frombuffer(x, dtype=np.uint8)
                                    for x in want])):
        raise AssertionError("entry step: parity differs from the host "
                             "encoder")
    poisoned = crcs.clone()
    poisoned.view(torch.int32)[0] ^= 0x5A5A5A5A
    bad = step(words, poisoned)
    tamper = {"crc_ok": bool(bad["crc_ok"]), "write_ok": bool(bad["write_ok"]),
              "write_acks": int(bad["write_acks"])}
    if tamper != {"crc_ok": False, "write_ok": False, "write_acks": 0}:
        raise AssertionError(f"entry step passed a poisoned CRC: {tamper}")
    counts = launch_counts()
    return {"phase": "entry", "device": str(device), "chunks": chunks,
            "bytes": chunks * CHECKSUM_CHUNK_SIZE,
            "crc_ok": True, "write_ok": True,
            "write_acks": int(out["write_acks"]),
            "parity_shape": list(out["parity"].shape), "parity_exact": True,
            "tamper": tamper, "setup_s": setup_s,
            "timer": "cuda events, median of 25 (step_ms: stream held; "
                     "call_ms: one call)" if device.type == "cuda"
                     else "host clock, median of 5",
            "step_ms": _part_ms(lambda: step(words, crcs), device),
            "call_ms": _part_ms(lambda: step(words, crcs), device, held=False),
            "launches": counts}


def dryrun_phase(device: torch.device, *,
                 chunks_per_position: int = DRYRUN_CHUNKS,
                 sizes: tuple = DRYRUN_SIZES) -> dict:
    """The ``dryrun`` phase: ``graft_entry.dryrun_multichip(n)`` for each n
    of ``sizes`` at ``chunks_per_position`` chunks a position (the data made
    on the device), every leg checked there, three times: the first run
    pays the first-use costs of its shapes (device memory, decode
    matrices), the second is reported, the third runs under
    ``torch.profiler`` on a card for each leg's device-busy share
    (:func:`leg_busy`). Per n the mapping, the geometry, the pod shape and
    shard width, each leg's host-clock seconds (the first run's beside
    them) and, on a card, the second run's peak device memory and the
    third run's busy shares."""
    reset_launches()
    runs = {}
    for n in sizes:
        first = dryrun_multichip(n, device,
                                 chunks_per_position=chunks_per_position)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        r = dryrun_multichip(n, device, chunks_per_position=chunks_per_position)
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else None
        busy = _profiled_legs(lambda: dryrun_multichip(
            n, device, chunks_per_position=chunks_per_position)) \
            if device.type == "cuda" else None
        runs[str(n)] = {"mapping": _mapping(r["devices"], device),
                        "ec": r["ec"], "pod": r["pod"],
                        "replication": r["replication"],
                        "write_acks": r["write_acks"],
                        "scatter_acks": r.get("scatter_acks"),
                        "gather_failed": r.get("gather_failed"),
                        "shard_bytes": r.get("shard_bytes"),
                        "parity_shape": r["parity_shape"],
                        "exact": r.get("exact", False),
                        "seconds": r["seconds"],
                        "first_seconds": first["seconds"],
                        "peak_bytes": peak, "leg_launches": r["leg_launches"],
                        "launches": r["launches"], "busy": busy}
    return {"phase": "dryrun", "device": str(device),
            "chunks_per_position": chunks_per_position,
            "bytes_per_position": chunks_per_position * CHECKSUM_CHUNK_SIZE,
            "timer": "host clock a leg, ended by a synchronize; busy: "
                     "torch.profiler trace of a third run",
            "runs": runs, "launches": launch_counts()}


#: Trace categories of device work in ``torch.profiler``'s Chrome trace.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _covered(intervals, a: float, b: float) -> float:
    """How much of [a, b] the intervals, sorted by start, cover (overlaps
    count once)."""
    total, end = 0.0, a
    for s, e in intervals:
        s, e = max(s, end), min(e, b)
        if e > s:
            total += e - s
            end = e
    return total


def leg_busy(events: list) -> dict | None:
    """Per ``dryrun.<leg>`` range of a Chrome trace's events (``ts`` and
    ``dur`` in microseconds): its host-clock span, the time within it in
    which a card ran a kernel, a copy or a memset (the union of their
    intervals, every card and stream together) and that time's share of
    the span. Each range ends after its leg's synchronize, so the leg's
    device work lies inside it. None when the trace holds no device work
    (not measured)."""
    work = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_WORK)
    if not work:
        return None
    legs = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith("dryrun."):
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            busy = _covered(work, a, b)
            legs[name[len("dryrun."):]] = {
                "span_ms": (b - a) / 1e3, "device_busy_ms": busy / 1e3,
                "busy_share": busy / (b - a) if b > a else None}
    return legs


def _profiled_legs(run) -> dict | None:
    """``run()`` under ``torch.profiler`` (CPU and CUDA activity), its
    Chrome trace written to ``build/dryrun_trace.json`` and read by
    :func:`leg_busy`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    trace = REPO / "build" / "dryrun_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    return leg_busy(json.loads(trace.read_text())["traceEvents"])


# ------------------------------------------------------- phase: restore

#: One data-parallel rank's checkpoint shard at real size: Llama-2-7B's
#: 6.74e9 parameters (Touvron et al. 2023, Table 1) in mixed-precision
#: training state, the bf16 model weights (2 bytes a parameter) beside the
#: fp32 master weights and Adam's two moments (K = 12 bytes a parameter):
#: ZeRO's 2Ψ + 12Ψ (Rajbhandari et al. 2020, section 3.1), partitioned over
#: 64 data-parallel ranks.
LLAMA2_7B_PARAMS = 6_740_000_000
CKPT_RANKS = 64
CKPT_PARAMS = LLAMA2_7B_PARAMS // CKPT_RANKS  # 105,312,500: 1.474 GB a rank
#: The checkpoint manager's default cold copy (``CheckpointManager(ec=)``)
#: and the shards the degraded run loses from every block of it.
CKPT_EC = (3, 2)
CKPT_LOST = (0, 3)
#: The restore's counters of the tensors checked by their own CRC.
TENSOR_COUNTS = ("restore.tensor_crc_bytes", "restore.tensor_clones")


def _align_chunks(nbytes: int) -> int:
    """Whole 512-byte chunks that hold ``nbytes``: the chunk range the
    restore's own CRC of a tensor reads."""
    return -(-nbytes // CHECKSUM_CHUNK_SIZE)


#: The chunk range of the restore's bf16 weights (2 bytes a parameter),
#: its largest tensor checked by its own CRC.
CKPT_MODEL_CHUNKS = _align_chunks(2 * CKPT_PARAMS)


def ckpt_state(n: int, seed: int, device: torch.device) -> dict:
    """One rank's state, made on ``device`` from ``seed``: flat fp32
    ``params``, ``adam_m`` and ``adam_v`` of ``n`` elements each, the bf16
    ``model`` (``params`` rounded to bf16, the weights the forward pass
    reads), an int64 ``step`` and an int8 ``flags`` tensor of 13. The last
    three are not 4-byte dtypes, so each is checked by its own CRC, and
    ``step``, last in name order, ends the payload off a 512-byte
    boundary."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tree = {name: torch.randn(n, generator=gen, device=device)
            for name in ("params", "adam_m", "adam_v")}
    tree["model"] = tree["params"].to(torch.bfloat16)
    tree["flags"] = torch.randint(-128, 128, (13,), dtype=torch.int8,
                                  generator=gen, device=device)
    tree["step"] = torch.tensor(1000 + seed, dtype=torch.int64, device=device)
    return tree


def lay_out_shard(workdir: Path, payload: np.ndarray, *, block_size: int,
                  hot: str, cold: str, ec: tuple = CKPT_EC,
                  setup_s: dict | None = None) -> tuple:
    """A shard payload as the checkpoint manager saves it: a 3x-replicated
    hot copy at ``hot`` and an RS(k,m) cold copy at ``cold`` (the host
    encoder; shard j of every block on store j). Returns (stores, metas);
    ``setup_s`` (optional) gains the wall seconds of the ``hot_copy``, the
    ``ec_encode`` and the ``ec_writes``."""
    k, m = ec
    clock = time.perf_counter
    parts = dict.fromkeys(("hot_copy", "ec_encode", "ec_writes"), 0.0)
    t0 = clock()
    addrs, stores, handles = layout.stores(workdir, max(3, k + m))
    metas = {hot: layout.write_replicated(handles, addrs, hot, payload,
                                          block_size, tag="ckpt_hot")}
    parts["hot_copy"] = clock() - t0
    blocks = []
    for i, off in enumerate(range(0, len(payload), block_size)):
        piece = payload[off : off + block_size]
        bid = f"blk_ckpt_ec_{i}"
        t0 = clock()
        shards = encode(piece, k, m)
        t1 = clock()
        for j, shard in enumerate(shards):
            handles[addrs[j]].write(bid, shard)
        parts["ec_encode"] += t1 - t0
        parts["ec_writes"] += clock() - t1
        crc = metas[hot]["blocks"][i]["checksum_crc32c"]
        blocks.append(layout.block_meta(bid, len(piece), addrs[: k + m], crc,
                                        k=k, m=m))
    metas[cold] = {"path": cold, "size": len(payload), "blocks": blocks}
    if setup_s is not None:
        setup_s.update(parts)
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
    """Every tensor bit-exact, of its dtype and shape, on ``device`` (the
    bf16 ``model`` as ``torch.bfloat16``); the 4-byte ones views of one
    word stream (no copy made)."""
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
    stage = dict.fromkeys(("read", "combined_crc", "assemble", "bounce",
                           "bounce_copy", "bounce_crc"), 0.0)
    rereads, before = reader.rereads, launch_counts()
    engine, counts = native.call_counts(), trace.counts()
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
            "launches": _delta(launch_counts(), before),
            "engine_calls": _delta(native.call_counts(), engine),
            "tensor_counts": {k: trace.counts().get(k, 0) - counts.get(k, 0)
                              for k in TENSOR_COUNTS}}


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
        setup_parts = {}
        stores, metas = lay_out_shard(
            tmp, np.frombuffer(payload, dtype=np.uint8),
            block_size=block_size, hot=hot, cold=cold, setup_s=setup_parts)
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
        non_word = [t for t in spec["tensors"]
                    if torch_dtype(t["dtype"]).itemsize != 4]
        own = {"restore.tensor_crc_bytes": sum(t["size"] for t in non_word),
               "restore.tensor_clones": 0}
        # On a card: one fused CRC launch a full block, one a tensor that
        # is not 4-byte words.
        full = sum(b["size"] % CHECKSUM_CHUNK_SIZE == 0 for b in blocks)
        cuda = device.type == "cuda"
        own_launches = len(non_word) * cuda
        unchecked = [r for r in runs if r["tensor_counts"] != own
                     or r["launches"]["crc32c_blocks"]
                     != full * cuda + own_launches]
        if unchecked:
            raise AssertionError(
                f"restore: the tensors' own CRCs did not check {own} in "
                f"{own_launches} launches beside {full * cuda}: {unchecked}")
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
        counts = launch_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    reduced = [] if params == CKPT_PARAMS else [
        f"params_per_rank {params} of {CKPT_PARAMS}"]
    if block_size != 64 * MiB:
        reduced.append(f"block_size {block_size} of {64 * MiB}")
    return {"phase": "restore", "device": str(device), "seed": seed,
            "shard": "Llama-2-7B (6.74e9 params, Touvron et al. 2023) "
                     "mixed-precision state: bf16 model weights (2 B/param) "
                     "+ fp32 master weights and Adam m, v (12 B/param), "
                     "ZeRO's 2+12 bytes a param (Rajbhandari et al. 2020, "
                     "section 3.1), 1 of 64 data-parallel ranks",
            "states": "flat: model (bf16), params, adam_m, adam_v (fp32) "
                      "one tensor each",
            "params_per_rank": params, "reduced": reduced,
            "tensors": {t["name"]: [t["dtype"], t["shape"]] for t in
                        spec["tensors"]},
            "payload_bytes": spec["size"], "block_size": block_size,
            "blocks": len(blocks), "tail_block_bytes": blocks[-1]["size"],
            "hot_replicas": 3, "ec": list(CKPT_EC), "ec_lost": list(CKPT_LOST),
            "pack_s": pack_s, "setup_s": setup_s,
            "setup_split_s": setup_parts, **runs[1],
            "first_run": runs[0], "flipped": flipped, "degraded": degraded,
            "degraded_gbps": degraded["gbps"], "exact": True,
            "launches": counts,
            # Of counts["crc32c_blocks"]: the tensors' own CRCs, one launch
            # a tensor in each of the four restores.
            "tensor_crc_launches": 4 * own_launches,
            "tensor_crc_chunks": [_align_chunks(t["size"])
                                  for t in non_word]}


# ------------------------------------------------------- phase: dataset

#: nanoGPT's GPT-2 pretraining read (``config/train_gpt2.py``): blocks of
#: 1,024 tokens in batches of 12, tokens stored as uint16 as in its
#: ``train.bin``; one record is one block, 2,048 bytes.
GPT2_BLOCK_TOKENS = 1024
GPT2_BATCH = 12
GPT2_VOCAB = 50257


def _read_records(source, tokens: np.ndarray, device, *, batches: int,
                  seed: int, num_workers: int, what: str,
                  after_first=None) -> dict:
    """``source`` (2,048-byte records of ``tokens``) through
    ``make_dataset(batch_size=12, shuffle_seed=seed)`` (``num_workers``
    spawned loader workers) and ``device_iterator`` onto ``device`` for
    ``batches`` batches, ``after_first()`` called once the first batch has
    landed; then every landed batch checked against the source records of
    the sampler's order, and ``source`` closed. The rates count the
    batches after the first (which pays the workers' start)."""
    record = source.record_bytes
    try:
        loader = make_dataset(source, batch_size=GPT2_BATCH,
                              shuffle_seed=seed, device=device,
                              num_workers=num_workers)
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
                    if after_first is not None:
                        after_first()
                if len(landed) == batches:
                    break
        finally:
            it.close()
        sync(device)
        seconds = time.perf_counter() - t0
        nrecords = len(source)
    finally:
        source.close()
    if len(landed) != batches:
        raise AssertionError(f"{what}: {len(landed)} of {batches} batches")
    order = EpochSampler(nrecords, seed=seed)
    want_idx = np.fromiter(order, dtype=np.int64,
                           count=nrecords)[: batches * GPT2_BATCH]
    records = tokens.reshape(-1, GPT2_BLOCK_TOKENS)
    for i, batch in enumerate(landed):
        want = records[want_idx[i * GPT2_BATCH : (i + 1) * GPT2_BATCH]]
        if batch.device != device or batch.dtype != torch.uint16 or \
                not np.array_equal(batch.cpu().numpy(), want):
            raise AssertionError(f"{what}: batch {i} differs")
    steady = seconds - first_s
    steady_records = (batches - 1) * GPT2_BATCH
    return {"record_bytes": record, "records": nrecords,
            "batch_size": GPT2_BATCH, "batches": batches,
            "num_workers": num_workers, "first_batch_s": first_s,
            "seconds": seconds, "records_per_s": steady_records / steady,
            "gbps": steady_records * record / steady / 1e9, "exact": True}


def dataset_path(device: torch.device, *, file_bytes: int = 1 << 30,
                 block_size: int = 64 * MiB, batches: int = 300,
                 seed: int = 0, num_workers: int = 2,
                 workdir: Path | None = None) -> dict:
    """The ``dataset`` phase: a 3x-replicated file of uint16 GPT-2 tokens
    read as 2,048-byte records through ``DfsRecordSource`` on a
    ``LocalClient`` into ``device`` for ``batches`` batches, each checked
    (:func:`_read_records`)."""
    root = Path(workdir) if workdir is not None else REPO / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dataset_", dir=root))
    try:
        t0 = time.perf_counter()
        tokens = np.random.default_rng(seed + 4).integers(
            0, GPT2_VOCAB, file_bytes // 2, dtype=np.uint16)
        addrs, stores, handles = layout.stores(tmp, 3)
        path = "/smoke/tokens"
        metas = {path: layout.write_replicated(handles, addrs, path,
                                               tokens.view(np.uint8),
                                               block_size)}
        setup_s = time.perf_counter() - t0
        source = DfsRecordSource(functools.partial(LocalClient, stores, metas),
                                 [path], GPT2_BLOCK_TOKENS * tokens.itemsize,
                                 dtype="uint16")
        read = _read_records(source, tokens, device, batches=batches,
                             seed=seed, num_workers=num_workers,
                             what="dataset")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "dataset", "device": str(device), "seed": seed,
            "source": "nanoGPT config/train_gpt2.py: block_size 1024, "
                      "batch_size 12, uint16 tokens",
            "file_bytes": file_bytes, "block_size": block_size,
            "setup_s": setup_s, **read}


# ---------------------------------------------------------- phase: cluster

#: The live cluster: 1 master and 5 chunkservers, so RS(3,2) puts its
#: shards on distinct servers and can lose two (the JAX bench's reason for
#: five, ``bench.py:270-272``).
CLUSTER_CS = 5
CLUSTER_EC = (3, 2)
CLUSTER_EC_BLOCKS = 4
#: The 1 GiB file: 16 blocks of the client's default 64 MiB.
CLUSTER_BLOCKS = 16
#: The phase's budget on the card (seconds): ``cut`` says why when the
#: big file was written at 8 blocks instead.
CLUSTER_BUDGET_S = 60.0


def _foreign_modules() -> list[str]:
    """Modules of the JAX package or of JAX in this process (the port must
    load none)."""
    return sorted(m for m in sys.modules
                  if m == "tpudfs" or m.startswith("tpudfs.")
                  or m.split(".")[0] in ("jax", "jaxlib"))


async def _timed_put(client, path: str, data: np.ndarray, ec=None) -> float:
    """One ``create_file``: logical GB/s."""
    t0 = time.perf_counter()
    await client.create_file(path, memoryview(data), ec=ec)
    return len(data) / (time.perf_counter() - t0) / 1e9


async def _cluster_pass(client, device, sources, *, local: bool) -> dict:
    """The three read paths into ``device`` with the local short circuit
    on or off (off: every byte crosses the blockport), each checked byte
    for byte: per block with lazy verify and one ``confirm`` (the big, tail
    and healthy EC files), the combiner in rounds of ``COMBINED_BATCH``,
    and the sweep pump (which reads colocated replicas only: over the wire
    every block takes its per-block fallback)."""
    client.local_reads = local
    local0 = client.local_read_blocks
    out = {}
    reader = HbmReader(client, [device])
    sync(device)
    t0 = time.perf_counter()
    big = await reader.read_file_to_device_blocks("/smoke/big", verify="lazy")
    sync(device)
    read_s = time.perf_counter() - t0
    tail = await reader.read_file_to_device_blocks("/smoke/tail",
                                                   verify="lazy")
    sync(device)
    t0 = time.perf_counter()
    ec = await reader.read_file_to_device_blocks("/smoke/ec", verify="lazy")
    sync(device)
    ec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    await reader.confirm(big + tail + ec)
    confirm_s = time.perf_counter() - t0
    if not all(b.verified for b in big + tail + ec) or reader.rereads:
        raise AssertionError("cluster: a clean read did not verify")
    for path, blocks in (("/smoke/big", big), ("/smoke/tail", tail),
                         ("/smoke/ec", ec)):
        _check_bytes(blocks, sources[path], path)
    nbig = sum(b.size for b in big)
    out["per_block"] = {"read_s": read_s, "gbps": nbig / read_s / 1e9,
                        "confirm_s": confirm_s, "ec_read_s": ec_s,
                        "ec_gbps": sum(b.size for b in ec) / ec_s / 1e9}
    del big, tail, ec

    meta = await client.get_file_info("/smoke/big")
    comb_reader = HbmReader(client, [device], batch_reads=COMBINED_BATCH)
    comb_reader.warm_batches(meta["blocks"][0]["size"] // CHECKSUM_CHUNK_SIZE)
    comb = comb_reader._combiner(device)
    sync(device)
    t0 = time.perf_counter()
    got = await comb_reader.read_file_to_device_blocks("/smoke/big",
                                                       verify="lazy")
    sync(device)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    await comb_reader.confirm(got)
    confirm_s = time.perf_counter() - t0
    if not all(b.verified for b in got) or comb_reader.rereads:
        raise AssertionError("cluster: a combined read did not verify")
    _check_bytes(got, sources["/smoke/big"], "/smoke/big")
    out["combined"] = {"read_s": read_s, "gbps": nbig / read_s / 1e9,
                       "confirm_s": confirm_s, "rounds": comb.rounds,
                       "fused_blocks": comb.blocks,
                       "stage_s": dict(comb.stage_s)}
    del got

    sweep_reader = HbmReader(client, [device])
    paths = ["/smoke/big", "/smoke/tail"]
    sync(device)
    t0 = time.perf_counter()
    got = await sweep_reader.sweep_paths_to_device(
        paths, round_blocks=COMBINED_BATCH, ring=3)
    sync(device)
    read_s = time.perf_counter() - t0
    nblocks = len(meta["blocks"])
    if not all(b.verified for b in got):
        raise AssertionError("cluster: the sweep returned an unverified block")
    _check_bytes(got[:nblocks], sources["/smoke/big"], "/smoke/big")
    _check_bytes(got[nblocks:], sources["/smoke/tail"], "/smoke/tail")
    if local and sweep_reader.sweep_blocks != nblocks:
        raise AssertionError(f"cluster: the pump served "
                             f"{sweep_reader.sweep_blocks} of {nblocks}")
    out["sweep"] = {"read_s": read_s,
                    "gbps": (nbig + len(sources["/smoke/tail"])) / read_s / 1e9,
                    "pump_blocks": sweep_reader.sweep_blocks,
                    "stage_s": dict(sweep_reader.sweep_stage_s)}
    out["local_read_blocks"] = client.local_read_blocks - local0
    if not local and out["local_read_blocks"]:
        raise AssertionError("cluster: a wire pass read a block off disk")
    return out


def _flip(cluster, addr: str, block_id: str, pos: int) -> str:
    """Flip one byte of ``block_id``'s replica in the data dir of the
    chunkserver at ``addr``; returns the file's path."""
    cs = next(c for c in cluster.chunkservers if c.addr == addr)
    path = BlockStore(cs.data_dir).block_path(block_id)
    with open(path, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x40]))
    return str(path)


async def _cluster_tamper(client, cluster, device, sources) -> dict:
    """One flipped byte in the first replica of a block, read each way:

    - short circuit (block n/2): the replica is read off disk without the
      host sidecar pass, so the device CRC (``crc32c_blocks`` at
      ``confirm``) must flag it and the verified re-read recover it from
      another replica;
    - over the wire (block n/2 + 1): the chunkserver's own sidecar verify
      must refuse the replica (``DATA_LOSS`` on a direct ``ReadBlock``),
      and the client's read fail over to another replica.

    Both reads must return the file's bytes."""
    meta = await client.get_file_info("/smoke/big")
    blocks = meta["blocks"]
    size = blocks[0]["size"]
    out = {}
    for name, i, local in (("short_circuit", len(blocks) // 2, True),
                           ("wire", len(blocks) // 2 + 1, False)):
        block = blocks[i]
        addr = block["locations"][0]
        _flip(cluster, addr, block["block_id"], 12345)
        client.local_reads = local
        reader = HbmReader(client, [device])
        layer = None
        if not local:
            try:
                await client._data_call(addr, "ReadBlock", {
                    "block_id": block["block_id"], "offset": 0, "length": 0},
                    timeout=60.0)
            except Exception as e:
                if not is_error_named(e, "RpcError") \
                        or e.code.name != "DATA_LOSS":
                    raise
                layer = "chunkserver sidecar verify (DATA_LOSS)"
            else:
                raise AssertionError("cluster: the chunkserver served the "
                                     "flipped replica")
        db = await reader.read_block_to_device(block, device, verify="lazy")
        await reader.confirm([db])
        if local:
            if reader.rereads != 1:
                raise AssertionError("cluster: the device CRC did not flag "
                                     "the flipped replica")
            layer = "device CRC32C at confirm (crc32c_blocks)"
        elif reader.rereads:
            raise AssertionError("cluster: the wire read returned the "
                                 "flipped bytes")
        want = sources["/smoke/big"][i * size : (i + 1) * size].tobytes()
        if not db.verified or device_array_to_bytes(db.array, db.size) != want:
            raise AssertionError(f"cluster: {name} tamper not recovered")
        out[name] = {"block": block["block_id"], "replica": addr,
                     "caught_by": layer, "recovered": True}
    return out


async def _cluster_degraded(client, cluster, device, sources) -> dict:
    """SIGKILL the two chunkservers that hold data shards of the EC file's
    first block (of its data-shard holders, the two holding the most data
    shards over the file, as ``ckpt_chaos.rebuild_after_kills`` ranks
    them), then read the EC file into ``device`` over the wire: bit-exact,
    every block that lost a data shard rebuilt by the GF(2^8) decode."""
    meta = await client.get_file_info("/smoke/ec")
    first = meta["blocks"][0]
    k = int(first["ec_data_shards"])
    held = data_shard_holders([meta])
    victims = sorted(first["locations"][:k], key=lambda a: (-held[a], a))[:2]
    lost = sum(1 for b in meta["blocks"]
               if set(b["locations"][: int(b["ec_data_shards"])])
               & set(victims))
    for cs in cluster.chunkservers:
        if cs.addr in victims:
            cs.kill()
    client.local_reads = False
    reader = HbmReader(client, [device])
    launches = gf_matmul_words.launches
    sync(device)
    t0 = time.perf_counter()
    got = await reader.read_file_to_device_blocks("/smoke/ec", verify="lazy")
    sync(device)
    read_s = time.perf_counter() - t0
    await reader.confirm(got)
    launches = gf_matmul_words.launches - launches
    _check_bytes(got, sources["/smoke/ec"], "/smoke/ec")
    if reader.ec_rebuilds != lost:
        raise AssertionError(f"cluster: {lost} blocks lost a data shard and "
                             f"{reader.ec_rebuilds} were rebuilt")
    if device.type == "cuda" and launches < lost:
        raise AssertionError(f"cluster: {lost} blocks lost a data shard and "
                             f"the GF(2^8) kernel launched {launches} times")
    present = tuple(i for i, a in enumerate(first["locations"])
                    if a not in victims)[:k]
    return {"victims": victims, "data_shards_held": dict(held),
            "blocks_lost_data": lost, "rebuilt_blocks": reader.ec_rebuilds,
            "gf256_launches": launches, "first_block_present": list(present),
            "read_s": read_s,
            "gbps": sum(b.size for b in got) / read_s / 1e9}


def cluster_phase(device: torch.device, *, block_size: int = 64 * MiB,
                  nblocks: int = CLUSTER_BLOCKS, tail_size: int = 1_000_003,
                  ec_blocks: int = CLUSTER_EC_BLOCKS, seed: int = 0,
                  workdir: Path | None = None) -> dict:
    """The ``cluster`` phase: a live cluster of 1 master and ``CLUSTER_CS``
    chunkserver processes (``tpudfs_torch.cluster.ProcessCluster``, the
    chunkservers' block cache off, so every wire read comes off their
    disks with their sidecar verify), driven through the port's own
    ``Client`` (``block_size`` blocks, CRC-64 ETags): the writes (the big
    file of ``nblocks`` blocks and the tail file at 3x, an RS(3,2) file of
    ``ec_blocks`` blocks; logical GB/s), the three read paths over the wire
    and short-circuited (:func:`_cluster_pass`), the tamper
    (:func:`_cluster_tamper`), two SIGKILLs and the degraded read
    (:func:`_cluster_degraded`). Raises on any mismatch or when a module of
    the JAX package or of JAX is loaded."""
    from tpudfs_torch.client.client import Client
    from tpudfs_torch.cluster import ProcessCluster

    root = Path(workdir) if workdir is not None else REPO / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cluster_", dir=root))
    rng = np.random.default_rng(seed)
    sources = {"/smoke/big": rng.integers(0, 256, nblocks * block_size,
                                          dtype=np.uint8),
               "/smoke/tail": rng.integers(0, 256, tail_size, dtype=np.uint8),
               "/smoke/ec": rng.integers(0, 256, ec_blocks * block_size,
                                         dtype=np.uint8)}
    t_phase = time.perf_counter()
    try:
        with ProcessCluster(tmp, n_cs=CLUSTER_CS, cache_blocks=0) as cluster:
            async def run() -> dict:
                client = Client([cluster.master_addr], block_size=block_size,
                                etag_mode="crc64")
                try:
                    t0 = time.perf_counter()
                    write = {
                        "big_gbps": await _timed_put(
                            client, "/smoke/big", sources["/smoke/big"]),
                        "tail_gbps": await _timed_put(
                            client, "/smoke/tail", sources["/smoke/tail"]),
                        "ec_gbps": await _timed_put(
                            client, "/smoke/ec", sources["/smoke/ec"],
                            ec=CLUSTER_EC)}
                    write["seconds"] = time.perf_counter() - t0
                    wire = await _cluster_pass(client, device, sources,
                                               local=False)
                    local = await _cluster_pass(client, device, sources,
                                                local=True)
                    tamper = await _cluster_tamper(client, cluster, device,
                                                   sources)
                    degraded = await _cluster_degraded(client, cluster,
                                                       device, sources)
                finally:
                    await client.close()
                return {"write": write, "wire": wire, "short_circuit": local,
                        "tamper": tamper, "degraded": degraded}

            out = asyncio.run(run())
            start_s = cluster.start_s
            pids = [p.pid for p in cluster.procs]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    foreign = _foreign_modules()
    if foreign:
        raise AssertionError(f"cluster: loaded {foreign}")
    return {"phase": "cluster", "device": str(device), "seed": seed,
            "masters": 1, "chunkservers": CLUSTER_CS, "server_pids": pids,
            "block_size": block_size, "nblocks": nblocks,
            "tail_size": tail_size, "ec": list(CLUSTER_EC),
            "ec_blocks": ec_blocks, "replicas": 3, "etag_mode": "crc64",
            "chunkserver_cache_blocks": 0, "start_s": start_s, **out,
            "seconds": time.perf_counter() - t_phase,
            "budget_s": CLUSTER_BUDGET_S,
            "cut": None if nblocks == CLUSTER_BLOCKS else
            f"big file cut to {nblocks} of {CLUSTER_BLOCKS} blocks by the "
            f"caller",
            "foreign_modules": foreign}


# ---------------------------------------------------------- phase: sharded

#: The deployment the ``sharded`` phase runs: the Helm chart's
#: (``deploy/helm/tpudfs``, as ``tpudfs_torch.cluster.HelmCluster`` starts
#: it): 3 config servers, shards ``shard-a`` and ``shard-z`` of 3 masters,
#: one spare group of 3 masters, 5 chunkservers in 3 racks, the masters'
#: split threshold at 100 requests a second, TLS on every transport.
SHARDED_TOPOLOGY = "helm-chart"
#: The checkpoint's base and the dataset's paths: the staging copy and its
#: home lie on either side of the bootstrap split at ``/m``, so the rename
#: is a cross-shard two-phase commit.
SHARDED_CKPT = "/a/ckpt"
SHARDED_STAGING = "/a/staging/tokens.bin"
SHARDED_TOKENS = "/z/train/tokens.bin"
#: Batches the sharded phase's dataset read lands (the ``dataset`` phase
#: lands 300).
SHARDED_BATCHES = 100
#: The phase's budget on the card (seconds).
SHARDED_BUDGET_S = 180.0
#: A file no restore reads, one replica of whose block the scrubber must
#: find corrupt; 1 MiB of the seed's bytes.
SHARDED_SCRUB_PROBE = "/z/scrub/probe.bin"
#: The chunkservers' scrub interval when the chart sets none
#: (``tpudfs/chunkserver/__main__.py``: ``--scrub-interval`` 60).
SCRUB_DEFAULT_S = 60.0
#: Seconds a save of step 2 may take to publish once its shard's leader
#: is killed, resumes included.
SHARDED_RESUME_S = 120.0
#: Metadata calls a second on the checkpoint's top-level prefix while the
#: job's other 63 ranks restart and poll (``list_steps``, manifest reads,
#: ``get_file_info`` of step 2's files). The masters fold each prefix's
#: count into a moving average every 5 s with weight 0.7 on the new
#: sample: a steady 150 reads 105 after one interval, over the chart's
#: threshold of 100.
SPLIT_TRAFFIC_OPS = 150.0
#: Seconds the traffic may run before the split must have moved the
#: prefix to a new shard.
SPLIT_WAIT_S = 90.0
#: Seconds a Raft group (the config group, a shard's masters) may take to
#: elect after its leader's kill.
CONFIG_FAILOVER_WAIT_S = 60.0


async def _first_answer(client, addrs, path: str, t_kill: float) -> dict:
    """Poll ``addrs`` (a shard's surviving masters) with ``GetFileInfo`` of
    ``path`` (a linearizable read: only a leader answers it) until one
    answers; the seconds from ``t_kill`` and the address that answered.
    Raises once ``CONFIG_FAILOVER_WAIT_S`` pass with no answer."""
    while True:
        if time.perf_counter() - t_kill > CONFIG_FAILOVER_WAIT_S:
            raise AssertionError(f"sharded: no leader among {addrs} "
                                 f"{CONFIG_FAILOVER_WAIT_S} s after the kill")
        for addr in addrs:
            try:
                await client.rpc.call(addr, "MasterService", "GetFileInfo",
                                      {"path": path}, timeout=1.0)
            except Exception:
                continue
            return {"failover_s": time.perf_counter() - t_kill,
                    "new_leader": addr}
        await asyncio.sleep(0.02)


async def _until_done(what: str, op, attempt=None) -> str:
    """Await ``attempt`` (a running first try) or ``op()``; when the cluster
    fails it, retry ``op()`` once a second for ``SHARDED_RESUME_S``, as a
    training job resumes a save (every such operation here is
    idempotent). Returns how it ended: ``first try`` or ``resumed after``
    the first failure."""
    try:
        await (attempt if attempt is not None else op())
        return "first try"
    except Exception as e:
        if not is_fault(e):
            raise
        outcome = f"resumed after {type(e).__name__}: {str(e)[:160]}"
    await retry_until(f"sharded: {what}", op, SHARDED_RESUME_S)
    return outcome


async def _save_through_failover(mgr, log, cluster, client, shard: str,
                                 tree: dict) -> dict:
    """Save step 2 and SIGKILL ``shard``'s leader once the step's first
    blob (its hot copy) has started: the save either publishes through the
    new leader or fails and is resumed until it publishes. Returns the
    kill, the failover time, the save's seconds and how it published."""
    first = ckptpaths.shard_data_path(mgr.base, 2, 0)
    t0 = time.perf_counter()
    save = asyncio.ensure_future(mgr.save(2, {0: tree}))
    started = asyncio.ensure_future(log.started(first).wait())
    await asyncio.wait([save, started], return_when=asyncio.FIRST_COMPLETED)
    if save.done():
        save.result()
        raise AssertionError("sharded: step 2 saved before its first blob "
                             "was seen")
    killed = await cluster.kill_master(shard, leader=True, client=client)
    t_kill = time.perf_counter()
    if killed is None:
        raise AssertionError(f"sharded: {shard} had no leader to kill")
    survivors = [a for a in cluster.shards[shard] if a != killed[1]]
    failover = await _first_answer(client, survivors,
                                   ckptpaths.manifest_path(mgr.base, 1),
                                   t_kill)
    outcome = await _until_done("step 2's save",
                                lambda: mgr.save(2, {0: tree}), save)
    return {"killed": {"name": killed[0], "addr": killed[1],
                       "leader": True, "shard": shard,
                       "during": f"step 2's put of {first}"},
            **failover, "seconds": time.perf_counter() - t0,
            "published": outcome}


async def _scrub_probe(client, cluster, seed: int) -> dict:
    """Write ``SHARDED_SCRUB_PROBE`` at 3x and flip one byte of its
    block's first replica on disk: no restore reads it, so only the
    holder's scrubber can find it. The block, the holder and when."""
    data = np.random.default_rng(seed + 9).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    await _until_done("the scrub probe's write", lambda: client.create_file(
        SHARDED_SCRUB_PROBE, data, overwrite=True))
    block = (await client.get_file_info(SHARDED_SCRUB_PROBE))["blocks"][0]
    addr = block["locations"][0]
    _flip(cluster, addr, block["block_id"], 4097)
    holder = next(cs.name for cs in cluster.chunkservers if cs.addr == addr)
    return {"path": SHARDED_SCRUB_PROBE, "block": block["block_id"],
            "holder": holder, "flipped_at": time.time()}


def _scrub_found(cluster, probe: dict, interval_s: float) -> dict:
    """Wait (at most one scrub interval and 30 s more from the flip) for
    the holder's scrubber to log the probe's block corrupt
    (``tpudfs/chunkserver/service.py``: ``scrubber found corruption in
    block``); raises if it never does. The seconds from the flip to the
    log line, by the line's own timestamp."""
    needle = f"scrubber found corruption in block {probe['block']}"
    deadline = probe["flipped_at"] + interval_s + 30.0
    while not (found := log_times(cluster, probe["holder"], needle)):
        if time.time() > deadline:
            raise AssertionError(
                f"sharded: {probe['holder']}'s scrubber never reported the "
                f"flipped replica of {probe['block']}")
        time.sleep(0.5)
    return {**probe, "interval_s": interval_s, "reports": len(found),
            "found_s": found[0] - probe["flipped_at"]}


async def _raft_terms(cluster, client) -> dict:
    """Each shard's live masters' Raft term and role: a term above 1
    counts the elections the run caused."""
    out = {}
    for m in cluster.masters.values():
        if m.proc.poll() is None:
            state = await client.raft_state(m.addr)
            out[m.name] = [state["term"], state["role"]]
    return out


async def _shard_listings(cluster, client, prefix: str) -> dict:
    """Each shard's own ``ListFiles`` of ``prefix`` (a client given only
    that shard's masters and no config server)."""
    from tpudfs_torch.client.client import Client

    out = {}
    for sid, addrs in cluster.shards.items():
        alone = Client(addrs, tls=cluster.client_tls, local_reads=False)
        try:
            out[sid] = await alone.list_files(prefix)
        finally:
            await alone.close()
    return out


def _sharded_infeed(cluster, client_factory, tokens: np.ndarray, shard: str,
                    device, *, batches: int, seed: int,
                    num_workers: int) -> dict:
    """The ``dataset`` phase's read of ``SHARDED_TOKENS`` over the cluster
    (:func:`_read_records`), ``shard``'s leader SIGKILLed after the first
    batch."""
    source = DfsRecordSource(client_factory, [SHARDED_TOKENS],
                             GPT2_BLOCK_TOKENS * tokens.itemsize,
                             dtype="uint16")
    killed = []
    read = _read_records(
        source, tokens, device, batches=batches, seed=seed,
        num_workers=num_workers, what="sharded: dataset",
        after_first=lambda: killed.append(
            asyncio.run(cluster.kill_master(shard))))
    if killed[0] is None:
        raise AssertionError(f"sharded: {shard} had no leader to kill")
    return {**read, "killed": {"name": killed[0][0], "addr": killed[0][1],
                               "leader": True, "shard": shard,
                               "during": "after the first batch"}}


async def _sharded_degraded(mgr, client, cluster, reader, spec: dict,
                            tree: dict, device) -> dict:
    """SIGKILL the two chunkservers that hold the most data shards of step
    2's cold copy, delete its hot copy, and restore step 2 again into
    ``device``: from the RS(3,2) copy, bit-exact, every block that lost a
    data shard rebuilt, once each by the GF(2^8) kernel on a card."""
    meta = await client.get_file_info(spec["ec_path"])
    victims, lost, held = data_shard_victims([meta])
    killed = []
    for cs in cluster.chunkservers:
        if cs.addr in victims:
            cs.kill()
            killed.append({"name": cs.name, "addr": cs.addr,
                           "leader": False, "role": "chunkserver"})
    await client.delete_file(spec["path"])
    rebuilds, launches = reader.ec_rebuilds, gf_matmul_words.launches
    degraded0 = mgr.stats["degraded_shard_reads"]
    sync(device)
    t0 = time.perf_counter()
    out = (await mgr.restore(2, device=device))[0]
    sync(device)
    seconds = time.perf_counter() - t0
    _check_restored(out, tree, device)
    rebuilt = reader.ec_rebuilds - rebuilds
    launches = gf_matmul_words.launches - launches
    if mgr.stats["degraded_shard_reads"] - degraded0 != 1:
        raise AssertionError("sharded: the degraded restore did not read "
                             "the cold copy")
    if not lost or rebuilt != lost or \
            launches != lost * (device.type == "cuda"):
        raise AssertionError(
            f"sharded: {lost} blocks lost a data shard; {rebuilt} rebuilt, "
            f"{launches} GF(2^8) launches")
    first = meta["blocks"][0]
    present = [i for i, a in enumerate(first["locations"])
               if a not in victims][: int(first["ec_data_shards"])]
    return {"victims": victims, "killed": killed,
            "data_shards_held": held, "blocks": len(meta["blocks"]),
            "blocks_lost_data": lost, "rebuilt_blocks": rebuilt,
            "gf256_launches": launches, "first_block_present": present,
            "seconds": seconds, "gbps": spec["size"] / seconds / 1e9}


def _prefix_op(client, paths: list[str]):
    """The op of ``helm_chaos.prefix_traffic`` on the checkpoint's
    top-level prefix: in every 30 calls one ``list_steps`` and one
    manifest read (its ``get_file_info`` and its bytes), and
    ``get_file_info`` of ``paths`` (step 2's files) for the rest, the
    calls the job's other ranks send while they restart and poll."""
    mgr = CheckpointManager(client, SHARDED_CKPT, num_shards=1, ec=CKPT_EC)

    async def op(i: int) -> None:
        if i % 30 == 0:
            await mgr.list_steps()
        elif i % 30 == 15:
            await mgr.read_manifest(2)
        else:
            await client.get_file_info(paths[i % len(paths)])

    return op


async def _checked_restore(mgr, tree: dict, device, block_size: int,
                           size: int, what: str) -> dict:
    """Step 2 restored into ``device`` through ``mgr``: bit-exact, and on a
    card ``crc32c_blocks`` launched for every full block and
    ``crc32c_chunks`` for the tail. Its seconds, GB/s and launches."""
    before = launch_counts()
    sync(device)
    t0 = time.perf_counter()
    got = (await mgr.restore(2, device=device))[0]
    sync(device)
    seconds = time.perf_counter() - t0
    _check_restored(got, tree, device)
    del got
    launched = _delta(launch_counts(), before)
    full = size // block_size
    if device.type == "cuda" and (launched["crc32c_blocks"] < full
                                  or launched["crc32c_chunks"] < 1):
        raise AssertionError(f"sharded: {what}: {full + 1} blocks "
                             f"restored, {launched}")
    return {"seconds": seconds, "gbps": size / seconds / 1e9,
            "blocks": -(-size // block_size), "launches": launched}


async def _split_under_restores(cluster, factory, client, mgr, spec: dict,
                                tree: dict, device, block_size: int,
                                rate: float) -> dict:
    """The hot-prefix split under a restarting job: a second client sends
    :func:`_prefix_op` traffic on ``SHARDED_CKPT``'s top-level prefix while a
    third restores step 2 into ``device`` back to back, until the config
    group's map hands the prefix to a new shard (at most ``SPLIT_WAIT_S``
    seconds). The new shard must be a 3-voter Raft group. Then step 2 is
    restored once more through ``mgr`` on the phase's long-lived
    ``client``, whose map predates the split: that restore must follow a
    ``REDIRECT:`` (``client.redirects``) and refresh its map. Every
    restore is bit-exact and launches its CRC kernels; each reports the
    map's version at its start and its end."""
    from tpudfs_torch.cluster import (find_leader_async, wait_moved,
                                      wait_redirect)

    prefix = SHARDED_CKPT + "/"
    await cluster.refresh_shards()
    source = cluster.shard_map.get_shard(prefix)
    v_before = cluster.shard_map.version
    traffic_client, restorer = factory(), factory()
    watch = factory(max_retries=2)
    stop = asyncio.Event()
    paths = [spec["path"], spec["ec_path"],
             ckptpaths.manifest_path(SHARDED_CKPT, 2)]

    async def version() -> int:
        if not await watch.refresh_shard_map():
            raise AssertionError("sharded: no config server answered")
        return watch.shard_map.version

    try:
        rmgr = CheckpointManager(restorer, SHARDED_CKPT, num_shards=1,
                                 ec=CKPT_EC,
                                 reader=HbmReader(restorer, [device]))
        load = asyncio.ensure_future(
            prefix_traffic(_prefix_op(traffic_client, paths), rate, stop))
        split = asyncio.ensure_future(
            wait_moved(watch, prefix, source, SPLIT_WAIT_S))
        restores = []
        try:
            while not split.done():
                v0 = await version()
                row = await _checked_restore(rmgr, tree, device, block_size,
                                             spec["size"], "under traffic")
                restores.append({**row, "map_version": [v0, await version()]})
            split_s = split.result()
        finally:
            stop.set()
            traffic = await load
            split.cancel()
        await cluster.refresh_shards(watch)
        target = cluster.shard_map.get_shard(prefix)
        peers = cluster.shards[target]
        leader = await find_leader_async(peers, client=watch)
        voters = [] if leader is None else \
            (await watch.raft_state(leader))["config"]["voters"]
        if sorted(voters) != sorted(peers) or len(voters) != 3:
            raise AssertionError(f"sharded: the split's shard {target} has "
                                 f"voters {voters}, peers {peers}")
        if sorted(peers) not in [sorted(g) for g in cluster.spare_groups]:
            raise AssertionError(f"sharded: {target} is not a spare group: "
                                 f"{peers}")
        # Only once the source has handed the range over does a client on
        # the old map meet a redirect.
        handoff_s = await wait_redirect(watch, cluster.shards[source],
                                        paths[-1], target)
        redirects, refreshes = client.redirects, client.map_refreshes
        v0 = client.shard_map.version
        stale = await _checked_restore(mgr, tree, device, block_size,
                                       spec["size"], "through the old map")
        stale.update(
            map_version=[v0, client.shard_map.version],
            redirects=client.redirects - redirects,
            map_refreshes=client.map_refreshes - refreshes)
        if not stale["redirects"] or not stale["map_refreshes"] or \
                client.shard_map.get_shard(prefix) != target:
            raise AssertionError(f"sharded: the restore through the old map "
                                 f"followed no redirect: {stale}")
    finally:
        for c in (traffic_client, restorer, watch):
            await c.close()
    v_after = cluster.shard_map.version
    return {"prefix": prefix, "from": source, "to": target, "peers": peers,
            "voters": sorted(voters), "split_s": split_s,
            "handoff_s": handoff_s,
            "map_version": [v_before, v_after], "traffic": traffic,
            "restores": restores,
            "across_split": sum(r["map_version"][0] != r["map_version"][1]
                                for r in restores),
            "stale_map_restore": stale}


def sharded_phase(device: torch.device, *, params: int = CKPT_PARAMS,
                  file_bytes: int = 1 << 30, block_size: int = 64 * MiB,
                  batches: int = SHARDED_BATCHES, seed: int = 0,
                  num_workers: int = 2, split_rps: float | None = None,
                  split_cooldown_s: float | None = None,
                  traffic_ops: float = SPLIT_TRAFFIC_OPS,
                  scrub_interval_s: float | None = None,
                  workdir: Path | None = None) -> dict:
    """The ``sharded`` phase: the Helm chart's deployment (``HelmCluster``:
    3 config servers, ``shard-a`` and ``shard-z`` of 3 masters, a spare
    group of 3, 5 chunkservers, TLS, the chunkservers' block cache off,
    their scrubber at the chart's 60 s unless ``scrub_interval_s`` says
    otherwise, which only a CPU rehearsal does; every chunkserver's
    blockport must be the native engine),
    driven through the port's ``Client`` as the chart's users build it
    (the three config servers alone, ``ClientTls``, ``local_reads=False``:
    every byte crosses an encrypted blockport), ``block_size`` blocks:

    0. a probe file no restore reads (:func:`_scrub_probe`), one byte of
       one replica flipped; by the phase's end the holder's scrubber
       must have logged it corrupt;
    1. the ``dataset`` phase's token file (``file_bytes``) written at 3x to
       ``SHARDED_STAGING``, then renamed across the shards to
       ``SHARDED_TOKENS``;
    2. the ``restore`` phase's rank shard (``ckpt_state(params)``) saved by
       the port's ``CheckpointManager`` at ``SHARDED_CKPT`` (3x hot copy,
       RS(3,2) cold copy): step 1 healthy; step 2 with its shard's leader
       SIGKILLed once its first blob has started, published through the
       new leader (:func:`_save_through_failover`);
    3. ``/`` listed across the shards, against each shard's own listing;
    4. step 2 restored into ``device``, every block verified on the
       device as it lands, bit-exact;
    5. the hot-prefix split under restores (:func:`_split_under_restores`:
       ``traffic_ops`` calls a second on ``/a/``, step 2 restored back to
       back until the map moves ``/a/`` to the spare group, then once
       through the long-lived client's old map, which must redirect);
    6. the token file read through the infeed, the owning shard's leader
       SIGKILLed after the first batch (:func:`_sharded_infeed`);
    7. the config group's leader SIGKILLed, and the degraded restore
       (:func:`_sharded_degraded`) through a client built from the config
       servers alone as the group elects (``config_failover_s``: the kill
       to the first ``FetchShardMap`` a new config leader answers).

    ``split_rps`` and ``split_cooldown_s`` set the masters'
    ``--split-threshold-rps`` and ``--split-cooldown-secs`` (the chart's
    100 and the masters' 30 s when None). A write or save the cluster
    fails (an election, by a kill or by the load) is resumed until it
    lands (:func:`_until_done`); the output says which were. Raises on any
    mismatch, or when a module of the JAX package or of JAX is loaded."""
    from tpudfs_torch.client.client import Client
    from tpudfs_torch.cluster import HelmCluster

    root = Path(workdir) if workdir is not None else REPO / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_", dir=root))
    tokens = np.random.default_rng(seed + 4).integers(
        0, GPT2_VOCAB, file_bytes // 2, dtype=np.uint16)
    t_phase = time.perf_counter()
    try:
        with HelmCluster(tmp, tls=True, cache_blocks=0,
                         split_threshold_rps=split_rps,
                         split_cooldown_s=split_cooldown_s,
                         scrub_interval_s=scrub_interval_s) as cluster:
            # The reference's checkpoint tiers' retry count (max_retries=8)
            # rides out an election the load alone can cause.
            factory = functools.partial(
                Client, config_addrs=list(cluster.config_addrs),
                tls=cluster.client_tls, block_size=block_size,
                max_retries=8, local_reads=False)

            async def run() -> dict:
                client = factory(etag_mode="crc64")
                try:
                    engines = {cs.name: (await client.rpc.call(
                        cs.addr, "ChunkServerService", "DataPort",
                        {}))["native"] for cs in cluster.chunkservers}
                    if not all(engines.values()):
                        raise AssertionError(
                            f"sharded: a chunkserver serves its TLS "
                            f"blockport from the asyncio fallback, not the "
                            f"native engine: {engines}")
                    out = {"engines": engines,
                           "scrub": await _scrub_probe(client, cluster,
                                                       seed)}
                    t0 = time.perf_counter()
                    written = await _until_done(
                        "the dataset's write",
                        lambda: client.create_file(
                            SHARDED_STAGING, memoryview(tokens.view(np.uint8)),
                            overwrite=True))
                    write_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    await client.rename_file(SHARDED_STAGING, SHARDED_TOKENS)
                    rename_s = time.perf_counter() - t0
                    owner = client.shard_map.get_shard
                    info = await client.get_file_info(SHARDED_TOKENS)
                    if owner(SHARDED_STAGING) == owner(SHARDED_TOKENS) or \
                            await client.get_file_info(SHARDED_STAGING) or \
                            info is None or info["size"] != tokens.nbytes:
                        raise AssertionError("sharded: the cross-shard "
                                             "rename did not land")
                    out["dataset"] = {
                        "bytes": tokens.nbytes, "write_s": write_s,
                        "write_gbps": tokens.nbytes / write_s / 1e9,
                        "rename_s": rename_s, "written": written,
                        "from": [SHARDED_STAGING, owner(SHARDED_STAGING)],
                        "to": [SHARDED_TOKENS, owner(SHARDED_TOKENS)]}

                    ckpt_shard = owner(SHARDED_CKPT + "/")
                    log = PutLog(client)
                    reader = HbmReader(client, [device])
                    mgr = CheckpointManager(log, SHARDED_CKPT, num_shards=1,
                                            ec=CKPT_EC, reader=reader)
                    trees.update({s: ckpt_state(params, seed + 1 + 2 * s,
                                                device) for s in (1, 2)})
                    sync(device)
                    t0 = time.perf_counter()
                    step1 = await _until_done(
                        "step 1's save", lambda: mgr.save(1, {0: trees[1]}))
                    step1_s = time.perf_counter() - t0
                    failover = await _save_through_failover(
                        mgr, log, cluster, client, ckpt_shard, trees[2])
                    steps = await mgr.list_steps()
                    if steps != [1, 2]:
                        raise AssertionError(f"sharded: steps {steps}")
                    # Step 2's own files, as its published manifest names
                    # them: the restores read these.
                    spec = (await mgr.read_manifest(2))["shards"][0]
                    out["save"] = {
                        "shard": ckpt_shard, "payload_bytes": spec["size"],
                        "step1_s": step1_s, "step1": step1,
                        "save_gbps": [spec["size"] / step1_s / 1e9,
                                      spec["size"] / failover["seconds"]
                                      / 1e9],
                        "failover": failover,
                        "stats": dict(mgr.stats)}

                    listed = await client.list_files("/")
                    own = await _shard_listings(cluster, client, "/")
                    union = sorted(p for ps in own.values() for p in ps)
                    want = {SHARDED_TOKENS,
                            ckptpaths.manifest_path(SHARDED_CKPT, 1),
                            ckptpaths.manifest_path(SHARDED_CKPT, 2)}
                    if listed != union or not want <= set(listed) or \
                            not all(own.values()) or any(
                                owner(p) != sid for sid, ps in own.items()
                                for p in ps):
                        raise AssertionError(
                            f"sharded: listed {listed}, shards {own}")
                    out["listing"] = {"files": len(listed),
                                      "per_shard": {k: len(v)
                                                    for k, v in own.items()}}
                    out["restore"] = await _checked_restore(
                        mgr, trees[2], device, block_size, spec["size"],
                        "the restore")
                    out["split"] = await _split_under_restores(
                        cluster, factory, client, mgr, spec, trees[2],
                        device, block_size, traffic_ops)
                    out["tokens_shard"] = owner(SHARDED_TOKENS)
                    out["raft"] = await _raft_terms(cluster, client)
                    return out
                finally:
                    await client.close()

            async def degraded() -> dict:
                killed = await cluster.kill_config(leader=True)
                t_kill = time.perf_counter()
                if killed is None:
                    raise AssertionError("sharded: no config leader to kill")
                # A restarted job's client: the config servers alone, built
                # while the config group elects.
                client = factory()
                try:
                    failover = asyncio.ensure_future(first_config_answer(
                        client.rpc, [a for a in cluster.config_addrs
                                     if a != killed[1]], t_kill,
                        CONFIG_FAILOVER_WAIT_S))
                    reader = HbmReader(client, [device])
                    mgr = CheckpointManager(client, SHARDED_CKPT,
                                            num_shards=1, ec=CKPT_EC,
                                            reader=reader)
                    spec = (await mgr.read_manifest(2))["shards"][0]
                    first_read_s = time.perf_counter() - t_kill
                    config = {"killed": {"name": killed[0],
                                         "addr": killed[1], "leader": True,
                                         "role": "config server"},
                              **await failover,
                              "first_read_s": first_read_s,
                              "client_map_refreshes": client.map_refreshes}
                    out = await _sharded_degraded(
                        mgr, client, cluster, reader, spec, trees[2], device)
                    return {**out, "config": config}
                finally:
                    await client.close()

            trees = {}
            out = asyncio.run(run())
            # The infeed's spawned loader workers build clients of their
            # own from the factory; it runs between the event loops.
            out["dataset_read"] = _sharded_infeed(
                cluster, factory, tokens, out.pop("tokens_shard"), device,
                batches=batches, seed=seed, num_workers=num_workers)
            out["degraded"] = asyncio.run(degraded())
            out["scrub"] = _scrub_found(
                cluster, out["scrub"], SCRUB_DEFAULT_S
                if scrub_interval_s is None else scrub_interval_s)
            start_s = cluster.start_s
            shards = cluster.shards
            spare_groups = cluster.spare_groups
            departures = cluster.departures
    except BaseException:
        # The servers' logs outlive a failed run, for the post-mortem.
        kept = root / "sharded_logs"
        shutil.rmtree(kept, ignore_errors=True)
        if (tmp / "logs").exists():
            shutil.copytree(tmp / "logs", kept, dirs_exist_ok=True)
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    foreign = _foreign_modules()
    if foreign:
        raise AssertionError(f"sharded: loaded {foreign}")
    config = out["degraded"].pop("config")
    kills = [out["save"]["failover"]["killed"],
             out["dataset_read"]["killed"], config["killed"],
             *out["degraded"]["killed"]]
    del trees
    reduced = [] if params == CKPT_PARAMS else [
        f"params_per_rank {params} of {CKPT_PARAMS}"]
    if file_bytes != 1 << 30:
        reduced.append(f"dataset {file_bytes} of {1 << 30} bytes")
    if block_size != 64 * MiB:
        reduced.append(f"block_size {block_size} of {64 * MiB}")
    if traffic_ops != SPLIT_TRAFFIC_OPS:
        reduced.append(f"prefix traffic {traffic_ops} of "
                       f"{SPLIT_TRAFFIC_OPS} calls a second")
    seconds = time.perf_counter() - t_phase
    return {"phase": "sharded", "device": str(device), "seed": seed,
            "topology": SHARDED_TOPOLOGY, "shards": shards,
            "spare_groups": spare_groups, "config_servers": 3,
            "chunkservers": len(out["engines"]),
            "tls": True, "engine": "native", "block_size": block_size,
            "chunkserver_cache_blocks": 0, "start_s": start_s, **out,
            "config": config,
            "save_gbps": out["save"]["save_gbps"],
            "failover_s": out["save"]["failover"]["failover_s"],
            "restore_gbps": out["restore"]["gbps"],
            "split_s": out["split"]["split_s"],
            "split_restore_gbps": [r["gbps"] for r in out["split"]["restores"]]
            + [out["split"]["stale_map_restore"]["gbps"]],
            "config_failover_s": config["config_failover_s"],
            "degraded_gbps": out["degraded"]["gbps"],
            "records_per_s": out["dataset_read"]["records_per_s"],
            "kills": kills, "seconds": seconds,
            "budget_s": SHARDED_BUDGET_S, "reduced": reduced,
            "cut": None if batches == SHARDED_BATCHES else
            f"dataset read cut to {batches} of {SHARDED_BATCHES} batches",
            "departures": departures,
            "foreign_modules": foreign}


# ------------------------------------------------------------ phase: bench


def bench_phase(device: torch.device, *, sweeps: int = 5,
                workdir: Path | None = None) -> dict:
    """The ``bench`` phase: ``tpudfs_torch.bench``'s local run at the
    bench's constants (``bench.REPS`` sets of ``bench.FILES`` files, each
    one ``bench.BLOCK_BYTES`` block at 3x replication; ``bench.run_local``
    lays them out and runs ``run_against(remote=False)``: raw infeed, the
    sweep pump's cold and warm windows, the write step and the RS(6,3)
    scatter step, one confirm), then the two read probes on set 0 of the
    same layout: ``read_profile.profile`` over its first
    ``read_profile.FILES`` files and ``sweep_lab.lab``'s ``sweeps``
    cold/warm pairs over the whole set. Then set 0 is read once more
    through the sweep pump and every block checked byte for byte."""
    root = Path(workdir) if workdir is not None else REPO / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_bench_", dir=root))
    try:
        paths = [bench.file_path(0, i) for i in range(bench.FILES)]
        reset_launches()
        t0 = time.perf_counter()
        client, result = bench.run_local(device, tmp)
        setup_s = result.pop("layout_s")
        bench_s = time.perf_counter() - t0 - setup_s
        profile = asyncio.run(read_profile.profile(
            client, device, paths[: read_profile.FILES]))
        lab = asyncio.run(sweep_lab.lab(client, device, paths, sweeps))
        launches = launch_counts()
        want = np.frombuffer(bench.block_data(), dtype=np.uint8)
        blocks = asyncio.run(HbmReader(client, [device])
                             .sweep_paths_to_device(paths))
        for path, b in zip(paths, blocks):
            _check_bytes([b], want, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "bench", "device": str(device),
            "files": bench.FILES, "sets": bench.REPS,
            "block_bytes": bench.BLOCK_BYTES, "replicas": 3,
            "setup_s": setup_s, "seconds": bench_s, "result": result,
            "read_profile": profile, "sweep_lab": lab, "exact": True,
            "launches": launches}


# ---------------------------------------------------------- card phases


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _build() -> dict:
    """nvcc for each kernel source and g++ for the native host engine,
    all started together; then every library loaded."""
    from concurrent.futures import ThreadPoolExecutor

    from tpudfs_torch.gpu import kernels

    def build_native() -> tuple[Path, float]:
        t0 = time.perf_counter()
        return native.build(), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        engine = pool.submit(build_native)
        info = kernels.build()
        so, gxx_s = engine.result()
    for name in info:
        kernels.lib(name)
    native.lib()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "host_engine": {"so": str(so.relative_to(REPO)), "gxx_s": gxx_s,
                            "sources": [str(p.relative_to(REPO))
                                        for p in native.SOURCES]},
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
    for cpb, counts in ((1, (1, 3, 4, 16)), (257, (1, 3, 4, 16)),
                        (131072, (1, 3, 4, 16)), (CKPT_MODEL_CHUNKS, (1,))):
        for nblocks in counts:
            words = device_words(rng, (nblocks * cpb, 128), device)
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
    round_words = device_words(rng, (nb * c, 128), device)
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
    words = device_words(rng, (c, 128), device)
    wcontrib = host_to_device(word_contrib_table(), device)
    crc = _timed_row(
        device, lambda: crc32c_chunks_device(words),
        lambda: crc32c_chunks_plain(words, wcontrib, inv_contrib()),
        c * 512 + 32 * 128 * 4 + c * 4,
        by_path["write"]["crc32c_chunks"], chunks=c)
    del words
    k, m = ec["ec"]
    w = ec["shard_bytes"] // 4
    shards = device_words(rng, (k + m, w), device)
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
    launches at that shape: the fused CRC of one block (one eager launch a
    full block), of the bf16 weights' chunk range (their own CRC, one
    launch a restore; the int8 and int64 tensors' one-chunk launches are
    ``kernels_vs_plain``'s one-chunk case) and the RS(k,m) decode that
    rebuilds one cold-copy block from k survivors (a (k, k) matrix at one
    block's padded shard width; its bound counts k rows in and k out)."""
    wcontrib = host_to_device(word_contrib_table(), device)
    rows = {}
    own = restore["tensor_crc_chunks"]
    for key, c, launches in (
            ("block", restore["block_size"] // CHECKSUM_CHUNK_SIZE,
             restore["launches"]["crc32c_blocks"]
             - restore["tensor_crc_launches"]),
            ("tensor", max(own),
             restore["tensor_crc_launches"] // len(own))):
        words = device_words(rng, (c, 128), device)
        fold = fold_table_device(c, device)
        rows[key] = _timed_row(
            device, lambda: crc32c_blocks_device(words, 1),
            lambda: crc32c_blocks_plain(words, 1, wcontrib, inv_contrib(),
                                        fold),
            _blocks_bytes(c, 1), launches, chunks=c, nblocks=1)
        del words, fold
    k, m = restore["ec"]
    w = pad_shard_len(-(-restore["block_size"] // k)) // 4
    present = tuple(i for i in range(k + m) if i not in restore["ec_lost"])
    dec = matrix_bits_device(decode_matrix(k, m, present), device)
    shards = device_words(rng, (k, w), device)
    decode = _timed_row(
        device, lambda: gf_matmul_words(shards, dec),
        lambda: gf_rows_plain(shards, dec), 2 * k * w * 4 + dec.numel() * 4,
        restore["launches"]["gf256_matmul"], words=w, matrix=[k, k])
    phase["crc32c_blocks_restore"] = rows["block"]
    phase["crc32c_blocks_restore_tensor"] = rows["tensor"]
    phase[f"gf256_restore_decode_{k}_{m}"] = decode
    by_name = {row["name"]: row for row in table}
    by_name["crc32c_blocks"]["at_restore_block"] = rows["block"]
    by_name["crc32c_blocks"]["at_restore_tensor"] = rows["tensor"]
    by_name["gf256_matmul"]["at_restore_decode"] = decode


def _entry_kernel_times(device, rng, entry_run, dryrun, phase,
                         table) -> None:
    """Both kernels at the entry points' shapes, added to the
    kernel_times phase and, nested, to the table's rows, each with its
    phase's launches of that kernel: the entry step's chunk CRCs, its
    write-step verify (3 replica groups of the same chunks in one launch)
    and its RS(6,3) parity (6 rows in, 3 out, at the step's shard width);
    the 8-position dryrun's RS(k,m) scatter encode and its (k, k+m)
    runtime gather decode around position 0 (the decode's bound counts the
    2k rows it needs, as at the write side's shapes); and each pod leg's
    RS(k2,m2) scatter encode at its shard width (2x4: RS(2,2), 3x3:
    RS(1,2)), which nothing in the pod leg decodes again."""
    c = entry_run["chunks"]
    wcontrib = host_to_device(word_contrib_table(), device)
    by_shape = {}
    for key, chunks in (("entry", c), ("entry_write_verify", 3 * c)):
        words = device_words(rng, (chunks, 128), device)
        by_shape[key] = "crc32c_chunks", _timed_row(
            device, lambda: crc32c_chunks_device(words),
            lambda: crc32c_chunks_plain(words, wcontrib, inv_contrib()),
            chunks * 512 + 32 * 128 * 4 + chunks * 4,
            entry_run["launches"]["crc32c_chunks"], chunks=chunks)
        del words
    w = c * CHECKSUM_CHUNK_SIZE // 6 // 4
    data = device_words(rng, (6, w), device)
    enc = host_to_device(coef_bits(6, 3), device)
    by_shape["entry_encode"] = "gf256_matmul", _timed_row(
        device, lambda: gf_matmul_words(data, enc),
        lambda: gf_rows_plain(data, enc), 9 * w * 4 + enc.numel() * 4,
        entry_run["launches"]["gf256_matmul"], words=w, matrix=[3, 6])
    del data
    run = dryrun["runs"][str(DRYRUN_SIZES[0])]
    k, m = run["ec"]
    w = run["shard_bytes"] // 4
    shards = device_words(rng, (k + m, w), device)
    enc = host_to_device(coef_bits(k, m), device)
    dec = matrix_bits_device(decode_select_matrices(
        k, m, k + m, k + m, run["gather_failed"])[0], device)
    gf_launches = dryrun["launches"]["gf256_matmul"]
    rows_in = shards[:k]
    by_shape[f"dryrun_encode_{k}_{m}"] = "gf256_matmul", _timed_row(
        device, lambda: gf_matmul_words(rows_in, enc),
        lambda: gf_rows_plain(rows_in, enc), (k + m) * w * 4 + enc.numel() * 4,
        gf_launches, words=w, matrix=[m, k])
    decode = _timed_row(
        device, lambda: gf_matmul_words(shards, dec),
        lambda: gf_rows_plain(shards, dec), 2 * k * w * 4 + dec.numel() * 4,
        gf_launches, words=w, matrix=[k, k + m])
    decode["bytes_read_by_design"] = (k + m + k) * w * 4 + dec.numel() * 4
    by_shape[f"dryrun_decode_{k}_{k + m}"] = "gf256_matmul", decode
    for n in DRYRUN_SIZES:
        pod = dryrun["runs"][str(n)]["pod"]
        k2, m2 = pod["ec"]
        w = pod["shard_bytes"] // 4
        pod_in = device_words(rng, (k2, w), device)
        enc = host_to_device(coef_bits(k2, m2), device)
        by_shape[f"pod_encode_{k2}_{m2}"] = "gf256_matmul", _timed_row(
            device, lambda: gf_matmul_words(pod_in, enc),
            lambda: gf_rows_plain(pod_in, enc),
            (k2 + m2) * w * 4 + enc.numel() * 4, gf_launches, words=w,
            matrix=[m2, k2], pod=pod["shape"])
        del pod_in
    rows = {row["name"]: row for row in table}
    for key, (name, row) in by_shape.items():
        phase[f"{name}_{key}"] = row
        rows[name][f"at_{key}"] = row


def _bench_kernel_times(device, rng, run, phase, table) -> None:
    """All three kernels at the bench's shapes, added to the kernel_times
    phase and, nested, to the table's rows, each with the bench phase's
    launches: the fused CRC of one full combiner round (``bench.BATCH_READS``
    blocks of ``bench.BLOCK_BYTES``) and of one block (a one-block round,
    and ``read_profile``'s per-block ``full`` stage), the chunk CRCs of the
    write step's verify (3 replica groups of ``bench.ICI_STEP_MB``) and of
    the scatter step's shard verify (9 shards), and the scatter step's
    RS(6,3) encode (6 rows in, 3 out, at the scatter's shard width for
    ``bench.ICI_STEP_MB``). These calls are small, so launch latency may be
    most of ``call_ms``."""
    launches = run["launches"]
    wcontrib = host_to_device(word_contrib_table(), device)
    cpb = bench.BLOCK_BYTES // CHECKSUM_CHUNK_SIZE
    nb = bench.BATCH_READS
    words = device_words(rng, (nb * cpb, 128), device)
    fold = fold_table_device(cpb, device)
    by_shape = {"bench_round": ("crc32c_blocks", _timed_row(
        device, lambda: crc32c_blocks_device(words, nb),
        lambda: crc32c_blocks_plain(words, nb, wcontrib, inv_contrib(), fold),
        _blocks_bytes(cpb, nb), launches["crc32c_blocks"], chunks=nb * cpb,
        nblocks=nb))}
    block = device_words(rng, (cpb, 128), device)
    by_shape["bench_block"] = "crc32c_blocks", _timed_row(
        device, lambda: crc32c_blocks_device(block, 1),
        lambda: crc32c_blocks_plain(block, 1, wcontrib, inv_contrib(), fold),
        _blocks_bytes(cpb, 1), launches["crc32c_blocks"], chunks=cpb,
        nblocks=1)
    del words, block

    def chunk_row(c: int) -> dict:
        words = device_words(rng, (c, 128), device)
        return _timed_row(
            device, lambda: crc32c_chunks_device(words),
            lambda: crc32c_chunks_plain(words, wcontrib, inv_contrib()),
            c * 512 + 32 * 128 * 4 + c * 4, launches["crc32c_chunks"],
            chunks=c)

    step_bytes = bench.ICI_STEP_MB << 20
    by_shape["bench_write_verify"] = "crc32c_chunks", chunk_row(
        3 * step_bytes // CHECKSUM_CHUNK_SIZE)
    per = -(-step_bytes // 6)  # a data shard's bytes, in whole chunks
    shard = -(-per // CHECKSUM_CHUNK_SIZE) * CHECKSUM_CHUNK_SIZE
    # The scatter's two CRC launches a round: all 9 shards, sent and
    # received.
    by_shape["bench_scatter_verify"] = "crc32c_chunks", chunk_row(
        9 * shard // CHECKSUM_CHUNK_SIZE)
    w = shard // 4
    data = device_words(rng, (6, w), device)
    enc = host_to_device(coef_bits(6, 3), device)
    by_shape["bench_scatter_encode"] = "gf256_matmul", _timed_row(
        device, lambda: gf_matmul_words(data, enc),
        lambda: gf_rows_plain(data, enc), 9 * w * 4 + enc.numel() * 4,
        launches["gf256_matmul"], words=w, matrix=[3, 6])
    rows = {row["name"]: row for row in table}
    for key, (name, row) in by_shape.items():
        phase[f"{name}_{key}"] = row
        rows[name][f"at_{key}"] = row


def _block_and_decode_rows(device, rng, run, key: str, ec: tuple, phase,
                           table) -> None:
    """The fused CRC of one block at ``run``'s block size and the RS(k, m)
    decode that rebuilt the first block ``run`` lost data shards of, from
    the shards that survived (a (k, k) matrix at one block's padded shard
    width; its bound counts k rows in and k out), each with ``run``'s
    launches: added to the kernel_times phase as
    ``crc32c_blocks_<key>_block`` and ``gf256_matmul_<key>_decode`` and,
    nested, to the table's rows."""
    launches = run["launches"]
    wcontrib = host_to_device(word_contrib_table(), device)
    c = run["block_size"] // CHECKSUM_CHUNK_SIZE
    fold = fold_table_device(c, device)
    block = device_words(rng, (c, 128), device)
    rows = {row["name"]: row for row in table}
    row = _timed_row(
        device, lambda: crc32c_blocks_device(block, 1),
        lambda: crc32c_blocks_plain(block, 1, wcontrib, inv_contrib(), fold),
        _blocks_bytes(c, 1), launches["crc32c_blocks"], chunks=c, nblocks=1)
    phase[f"crc32c_blocks_{key}_block"] = row
    rows["crc32c_blocks"][f"at_{key}_block"] = row
    del block
    k, m = ec
    w = pad_shard_len(-(-run["block_size"] // k)) // 4
    present = tuple(run["degraded"]["first_block_present"])
    dec = matrix_bits_device(decode_matrix(k, m, present), device)
    shards = device_words(rng, (k, w), device)
    row = _timed_row(
        device, lambda: gf_matmul_words(shards, dec),
        lambda: gf_rows_plain(shards, dec), 2 * k * w * 4 + dec.numel() * 4,
        launches["gf256_matmul"], words=w, matrix=[k, k],
        present=list(present))
    phase[f"gf256_matmul_{key}_decode"] = row
    rows["gf256_matmul"][f"at_{key}_decode"] = row


def _cluster_kernel_times(device, rng, run, phase, table) -> None:
    """Both kernels at the cluster phase's shapes, with its launches: the
    fused CRC of one combiner round (``COMBINED_BATCH`` blocks), then
    :func:`_block_and_decode_rows` (the per-block path's block, the EC
    file's rebuild)."""
    launches = run["launches"]
    wcontrib = host_to_device(word_contrib_table(), device)
    c = run["block_size"] // CHECKSUM_CHUNK_SIZE
    nb = COMBINED_BATCH
    fold = fold_table_device(c, device)
    words = device_words(rng, (nb * c, 128), device)
    row = _timed_row(
        device, lambda: crc32c_blocks_device(words, nb),
        lambda: crc32c_blocks_plain(words, nb, wcontrib, inv_contrib(), fold),
        _blocks_bytes(c, nb), launches["crc32c_blocks"], chunks=nb * c,
        nblocks=nb)
    del words
    phase["crc32c_blocks_cluster_round"] = row
    next(r for r in table if r["name"] == "crc32c_blocks")[
        "at_cluster_round"] = row
    _block_and_decode_rows(device, rng, run, "cluster", run["ec"], phase,
                           table)


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
    host = _engine_counted(lambda: host_engine_phase(seed=args.seed))
    emit(host)
    result = _engine_counted(lambda: read_path(device, seed=args.seed))
    ec_rebuild = result.pop("ec_rebuild")
    batched = [result.pop(name) for name in ("combined", "sweep", "infeed")]
    emit(result)
    emit(ec_rebuild)
    for phase in batched:
        emit(phase)
    write = _engine_counted(lambda: write_path(device, seed=args.seed))
    emit(write)
    ec = ec_collective(device, seed=args.seed)
    emit(ec)
    entry_run = entry_phase(device)
    emit(entry_run)
    dryrun = dryrun_phase(device)
    emit(dryrun)
    restore = _engine_counted(lambda: restore_path(device, seed=args.seed))
    emit(restore)
    cluster = _engine_counted(lambda: _counted(
        lambda: cluster_phase(device, seed=args.seed)))
    emit(cluster)
    sharded = _engine_counted(lambda: _counted(
        lambda: sharded_phase(device, seed=args.seed)))
    emit(sharded)
    dataset = _counted(lambda: dataset_path(device, seed=args.seed))
    emit(dataset)
    bench_run = _engine_counted(lambda: bench_phase(device))
    emit(bench_run)
    for phase in (host, result, write, restore, cluster, sharded,
                  bench_run):
        calls = phase["engine_calls"]
        never = [k for k in PATH_ENGINE[phase["phase"]] if not calls[k]]
        if never:
            raise AssertionError(f"{phase['phase']}: host engine entries "
                                 f"never called: {never}")
    by_path = {"read_path": result["launches"],
               **{p["phase"]: p["launches"]
                  for p in batched + [write, ec, entry_run, dryrun, restore,
                                      cluster, sharded, dataset,
                                      bench_run]}}
    for path, counts in by_path.items():
        never = [k for k in PATH_KERNELS[path] if not counts[k]]
        if never:
            raise AssertionError(f"{path}: kernels never launched: {never}")
    counts = {name: sum(c[name] for c in by_path.values()) for name in KERNELS}
    phase, table = _kernel_times(device, rng, counts, result["block_size"])
    _write_kernel_times(device, rng, by_path, write, ec, phase, table)
    _restore_kernel_times(device, rng, restore, phase, table)
    _entry_kernel_times(device, rng, entry_run, dryrun, phase, table)
    _bench_kernel_times(device, rng, bench_run, phase, table)
    _cluster_kernel_times(device, rng, cluster, phase, table)
    _block_and_decode_rows(device, rng, sharded, "sharded", CKPT_EC, phase,
                           table)
    emit(phase)
    emit({"phase": "kernels", "launches": counts, "by_path": by_path})
    emit({"kernels": table})
    foreign = _foreign_modules()
    if foreign:
        raise AssertionError(f"the smoke loaded {foreign}")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
