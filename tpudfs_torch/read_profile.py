"""Read-path stage breakdown — port of the JAX package's
``scripts/read_profile.py``, a probe of the bench (not part of it): each
stage of the DFS -> device sweep timed on its own over the same files, to
locate the bottleneck. Stages are cumulative:

- ``meta``: ``get_file_info`` only;
- ``disk``: + the verified pread of every block (bytes stay on the host);
- ``h2d``: + the copy into device memory (unverified reads, no CRC);
- ``full``: + the per-block on-device CRC (``verify="lazy"``);
- ``fused``: the read combiner instead (one native pread, one copy and one
  fused CRC launch per round of up to ``bench.BATCH_READS`` blocks).

``full`` and ``fused`` are windows of the bench's own harness
(``bench.timed_sweep``: GC parked, one completion wait).

:func:`profile` takes the client and device from the caller (the bench's
file sets through a ``LocalClient``, or the reference ``Client`` on a live
cluster) and returns the stages; ``chip_smoke.py``'s ``bench`` phase runs
it on the card. The lazy verdicts of ``full`` and ``fused`` are confirmed
after their windows and must all pass.
"""

from __future__ import annotations

import asyncio
import time

from tpudfs_torch import bench
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE
from tpudfs_torch.gpu import host_to_device, resolve_device
from tpudfs_torch.gpu.crc32c_cuda import bytes_to_words
from tpudfs_torch.gpu.hbm_reader import HbmReader
from tpudfs_torch.graft_entry import sync

#: Files a profile reads (64 x 1 MiB in the reference) and the concurrency
#: of its per-block stages.
FILES = 64
CONC = 12


async def _confirmed(reader: HbmReader, blocks: list, stage: str) -> None:
    await reader.confirm(blocks)
    if not all(b.verified for b in blocks):
        raise AssertionError(f"read_profile {stage}: a block failed its CRC")


async def profile(client, device=None, paths: list[str] = ()) -> dict:
    """The five stages over ``paths`` on ``device`` (default ``cuda:0``):
    ``{stage: {"seconds", "gbps"}}`` (``meta``: ``files_per_s``), with the
    file and byte counts."""
    device = resolve_device(device)
    paths = list(paths)
    if not paths:
        raise ValueError("read_profile needs at least one path")
    sem = asyncio.Semaphore(CONC)
    reader = HbmReader(client, [device])
    # Warm-up outside every window: the per-block path's first copy and
    # CRC launch.
    await _confirmed(reader, await reader.read_file_to_device_blocks(
        paths[0], verify="lazy"), "warm-up")

    async def fan(fn, items) -> tuple:
        t0 = time.perf_counter()
        out = await asyncio.gather(*(fn(it) for it in items))
        return out, time.perf_counter() - t0

    async def meta_one(path: str):
        async with sem:
            return await client.get_file_info(path)

    metas, dt = await fan(meta_one, paths)
    nbytes = sum(int(b["size"]) for m in metas for b in m["blocks"])
    stages = {"meta": {"seconds": dt, "files_per_s": len(paths) / dt}}

    def rate(seconds: float) -> dict:
        return {"seconds": seconds, "gbps": nbytes / seconds / 1e9}

    async def disk_one(meta: dict):
        async with sem:
            return [await client._read_block_range(b, 0, 0)
                    for b in meta["blocks"]]

    _, dt = await fan(disk_one, metas)
    stages["disk"] = rate(dt)

    async def h2d_one(meta: dict):
        # The "full" stage minus the CRC: unverified fetch (as the lazily
        # verified read fetches) + the copy, so full - h2d isolates the
        # device check.
        async with sem:
            out = []
            for b in meta["blocks"]:
                data = await client._read_block_range(b, 0, 0,
                                                      local_verify=False)
                out.append(await asyncio.to_thread(
                    host_to_device, bytes_to_words(data), device))
            return out

    t0 = time.perf_counter()
    await asyncio.gather(*(h2d_one(m) for m in metas))
    sync(device)
    stages["h2d"] = rate(time.perf_counter() - t0)

    blocks, gbps = await bench.timed_sweep(
        paths, lambda p: reader.read_file_to_device_blocks(p, verify="lazy"),
        CONC)
    stages["full"] = rate(nbytes / gbps / 1e9)
    await _confirmed(reader, blocks, "full")

    fused_reader = HbmReader(client, [device], batch_reads=bench.BATCH_READS)
    fused_reader.warm_batches(
        int(metas[0]["blocks"][0]["size"]) // CHECKSUM_CHUNK_SIZE)
    blocks, gbps = await bench.timed_sweep(
        paths, lambda p: fused_reader.read_file_to_device_blocks(
            p, verify="lazy"), bench.FUSED_READ_CONCURRENCY)
    stages["fused"] = rate(nbytes / gbps / 1e9)
    await _confirmed(fused_reader, blocks, "fused")
    comb = fused_reader._combiner(device)
    stages["fused"].update(rounds=comb.rounds, blocks=comb.blocks)
    return {"files": len(paths), "bytes": nbytes, "concurrency": CONC,
            **stages}
