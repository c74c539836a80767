#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        # needs one CUDA card; exits 1 without one

Builds the hand-written kernels from ``tpudfs_torch/gpu/csrc`` with nvcc,
holds each against its plain PyTorch twin on the card, drives the verified
read into device memory at real size (the port's main path), times each
kernel at the main path's shapes, and checks every byte that comes out.

Output (stdout): the card's ``nvidia-smi`` name and power limit, one JSON
line per phase (``device``, ``build``, ``kernels_vs_plain``, ``read_path``,
``kernel_times``, ``kernels``), the kernel table ``{"kernels": [...]}``,
and last ``{"ok": true, "device": {...}}``. Any mismatch raises: the run
exits non-zero and prints no result.

The read path: three replica stores laid out under ``build/`` in the
chunkserver's on-disk format (3x replication at rest) holding a 1 GiB file
of 16 x 64 MiB blocks and a 1,000,003-byte file (a tail block that is not
512-aligned), plus nine shard stores holding one 64 MiB RS(6,3) block with
shards 0, 2 and 7 missing. Everything is read through
``HbmReader(LocalClient(...))`` with ``verify="lazy"`` and settled with one
``confirm`` (twice: the first pass pays first-use costs, the second is
reported); a flipped byte in one replica must be flagged and recovered.
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
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c_chunks, crc32c_fold
from tpudfs_torch.common.erasure import encode
from tpudfs_torch.gpu import host_to_device, u32_to_i64
from tpudfs_torch.gpu.crc32c_cuda import (
    block_crc_device,
    crc32c_chunks_device,
    crc32c_chunks_plain,
    inv_contrib,
    word_contrib_table,
)
from tpudfs_torch.gpu.hbm_reader import HbmReader, device_array_to_bytes
from tpudfs_torch.gpu.rs_cuda import (
    coef_bits,
    decode_matrix,
    gf_matmul_words,
    gf_rows_plain,
    matrix_bits_device,
)

REPO = Path(__file__).resolve().parent
MiB = 1 << 20
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
    "gf256_matmul": {
        "route": "cuda", "source": "tpudfs_torch/gpu/csrc/gf256.cu",
        "replaces": "tpudfs/tpu/rs_pallas.py:112",
        "wrapper": gf_matmul_words,
    },
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
    ec = await reader.read_file_to_device_blocks("/smoke/ec", verify="lazy")
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
            "blocks": len(every), "pending_at_confirm": pending,
            "tail_block_bytes": tail[-1].size}


async def _host_breakdown(client: LocalClient, metas, device) -> dict:
    """The read window's host steps alone, at the same concurrency: the
    pread of every block of the big file into fresh grids, then their
    pageable host->device copies; and, on a card, the copy rate from one
    pinned buffer (what a pinned staging ring would reach)."""
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
    return out


async def _tamper(reader: HbmReader, client: LocalClient, metas, sources,
                  device) -> dict:
    """Flip one byte in the first replica of one block: confirm must flag it
    (raise without retry), and with retry recover it from another replica."""
    blocks = metas["/smoke/big"]["blocks"]
    i = len(blocks) // 2
    block = blocks[i]
    store = client._local_stores[block["locations"][0]][0]
    p = store.block_path(block["block_id"])
    with open(p, "r+b") as f:
        f.seek(12345)
        byte = f.read(1)
        f.seek(12345)
        f.write(bytes([byte[0] ^ 0x40]))
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
    if reader.rereads != before + 1 or not db.verified:
        raise AssertionError("tampered block was not recovered")
    size = block["size"]
    want = sources["/smoke/big"][i * size : (i + 1) * size].tobytes()
    if device_array_to_bytes(db.array, db.size) != want:
        raise AssertionError("recovered block bytes differ")
    return {"block": block["block_id"], "flagged": True, "recovered": True}


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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "read_path", "device": str(device), "seed": seed,
            "block_size": block_size, "nblocks": nblocks,
            "tail_size": tail_size, "ec": list(ec), "ec_lost": list(lost),
            "replicas": 3, "setup_s": setup_s, **passes[-1],
            "first_pass": passes[0], "host": host, "tamper": tamper,
            "launches": counts}


# ---------------------------------------------------------- card phases


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _build() -> dict:
    from tpudfs_torch.gpu import kernels

    t0 = time.perf_counter()
    info = kernels.build()
    for name in info:
        kernels.lib(name)
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "kernels": {
                name: {"so": str(Path(i["so"]).relative_to(REPO)),
                       "nvcc_s": i["seconds"],
                       "ptxas": [ln for ln in i["ptxas"].splitlines()
                                 if "registers" in ln or "spill" in ln]}
                for name, i in info.items()}}


def _gf_cases() -> list[tuple]:
    """(label, (rows, cols, 8) bit-planes as host arrays) for kernel checks:
    RS(6,3) and RS(4,2) encode, RS(6,3) decode for three erasure patterns."""
    cases = [("encode_6_3", coef_bits(6, 3)), ("encode_4_2", coef_bits(4, 2))]
    for lost in ((0, 2, 7), (1, 4), (6, 7, 8)):
        present = tuple(i for i in range(9) if i not in lost)
        cases.append((f"decode_6_3_lost_{'_'.join(map(str, lost))}",
                      decode_matrix(6, 3, present)))
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
            "crc32c_chunks": crc, "gf256_matmul": gf}


def _time_ms(fn, device, runs: int = 25, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_times(device: torch.device, rng, counts: dict,
                  block_size: int) -> tuple[dict, list]:
    """Kernel and plain times at the main path's shapes: one 64 MiB block's
    chunk CRCs, and RS(6,3) decode (plus encode) of one 64 MiB block."""
    c = block_size // CHECKSUM_CHUNK_SIZE
    words = _random_words(rng, (c, 128), device)
    wcontrib = host_to_device(word_contrib_table(), device)
    crc_ms = _time_ms(lambda: crc32c_chunks_device(words), device)
    crc_plain = _time_ms(lambda: crc32c_chunks_plain(words, wcontrib,
                                                     inv_contrib()), device)
    block_crc_ms = _time_ms(lambda: block_crc_device(words), device)
    crc_err = _same(crc32c_chunks_device(words),
                    crc32c_chunks_plain(words, wcontrib, inv_contrib()))
    crc_bytes = c * 512 + 32 * 128 * 4 + c * 4

    slen = -(-block_size // 6)
    w = -(-slen // 128) * 128 // 4  # padded shard words (2,796,224 at 64 MiB)
    present = (1, 3, 4, 5, 6, 8)  # shards 0, 2, 7 lost
    dec = matrix_bits_device(decode_matrix(6, 3, present), device)
    enc = host_to_device(coef_bits(6, 3), device)
    shards = _random_words(rng, (6, w), device)
    dec_ms = _time_ms(lambda: gf_matmul_words(shards, dec), device)
    dec_plain = _time_ms(lambda: gf_rows_plain(shards, dec), device)
    enc_ms = _time_ms(lambda: gf_matmul_words(shards, enc), device)
    enc_plain = _time_ms(lambda: gf_rows_plain(shards, enc), device)
    dec_err = _same(gf_matmul_words(shards, dec), gf_rows_plain(shards, dec))
    dec_bytes = 6 * w * 4 * 2 + dec.numel() * 4
    enc_bytes = 6 * w * 4 + 3 * w * 4 + enc.numel() * 4

    def bound(nbytes: int) -> float:
        return nbytes / HBM_BYTES_PER_S * 1e3

    phase = {
        "phase": "kernel_times", "runs": 25, "stat": "median",
        "timer": "cuda events", "bound_rate": "3.35 TB/s HBM (H100 SXM)",
        "crc32c_chunks": {"chunks": c, "ms": crc_ms, "plain_ms": crc_plain,
                          "bound_ms": bound(crc_bytes),
                          "block_crc_ms": block_crc_ms},
        "gf256_decode_6_3": {"words": w, "ms": dec_ms, "plain_ms": dec_plain,
                             "bound_ms": bound(dec_bytes)},
        "gf256_encode_6_3": {"words": w, "ms": enc_ms, "plain_ms": enc_plain,
                             "bound_ms": bound(enc_bytes)},
        "library_ms": None, "library_reason": NO_LIBRARY,
        "bound_by": "bytes (no published integer-ALU peak)",
    }
    table = [
        {"name": "crc32c_chunks", "launches": counts["crc32c_chunks"],
         "max_abs_err": crc_err, "ms": crc_ms, "plain_ms": crc_plain,
         "bound_ms": bound(crc_bytes)},
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
    emit(result)
    counts = result["launches"]
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the main path never launched: {counts}")
    phase, table = _kernel_times(device, rng, counts, result["block_size"])
    emit(phase)
    emit({"phase": "kernels", "launches": counts})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
