"""Read-sweep laboratory — port of the JAX package's ``scripts/sweep_lab.py``,
a probe of the bench (not part of it): one dataset, then N alternating
cold/warm sweeps, each recorded on its own — a view of the
window-to-window spread that the bench's medians summarize.

- cold: ``read_file_to_device_blocks(verify="lazy")`` per file, at
  ``bench.FUSED_READ_CONCURRENCY`` files in flight, through the read
  combiner's fused rounds (metadata fetched in the sweep);
- warm: ``read_meta_blocks_fast`` over metadata cached once, the same
  rounds.

Each sweep is one of the bench's windows (``bench.timed_sweep``: GC
parked, one completion wait) and carries the combiner's own stage times
(``stage_s``: round buffer allocation, the native pread, the copy + CRC
enqueue, the copy waits) and rounds; the reference patched
``ReadCombiner._fill_buffer`` and ``jax.device_put`` to get them. Every
sweep's verdicts are confirmed after its window and must all pass.
"""

from __future__ import annotations

import asyncio
import statistics

from tpudfs_torch import bench
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE
from tpudfs_torch.gpu import resolve_device
from tpudfs_torch.gpu.hbm_reader import HbmReader

SWEEPS = 6


def _spread(xs: list[float]) -> dict:
    return {"median": statistics.median(xs), "win": [min(xs), max(xs)]}


async def lab(client, device=None, paths: list[str] = (),
              sweeps: int = SWEEPS) -> dict:
    """``sweeps`` cold/warm pairs over ``paths`` on ``device`` (default
    ``cuda:0``): each sweep's GB/s, seconds, combiner rounds and stage
    seconds, and the medians and ``[min, max]`` of each kind."""
    device = resolve_device(device)
    paths = list(paths)
    if not paths or sweeps < 1:
        raise ValueError("sweep_lab needs at least one path and one sweep")
    reader = HbmReader(client, [device], batch_reads=bench.BATCH_READS)
    metas = await asyncio.gather(*(client.get_file_info(p) for p in paths))
    reader.warm_batches(int(metas[0]["blocks"][0]["size"])
                        // CHECKSUM_CHUNK_SIZE)
    comb = reader._combiner(device)

    async def sweep(read_fn, items) -> dict:
        stage0, rounds0 = dict(comb.stage_s), comb.rounds
        blocks, gbps = await bench.timed_sweep(
            items, read_fn, bench.FUSED_READ_CONCURRENCY)
        await reader.confirm(blocks)
        if not all(b.verified for b in blocks):
            raise AssertionError("sweep_lab: a block failed its CRC")
        return {"gbps": gbps,
                "seconds": sum(b.size for b in blocks) / gbps / 1e9,
                "rounds": comb.rounds - rounds0,
                "stage_s": {k: comb.stage_s[k] - stage0[k] for k in stage0}}

    out = []
    for _ in range(sweeps):
        cold = await sweep(
            lambda p: reader.read_file_to_device_blocks(p, verify="lazy"),
            paths)
        warm = await sweep(
            lambda m: reader.read_meta_blocks_fast(m, device), metas)
        out.append({"cold": cold, "warm": warm})
    return {"files": len(paths), "batch_reads": bench.BATCH_READS,
            "concurrency": bench.FUSED_READ_CONCURRENCY, "sweeps": out,
            "cold": _spread([s["cold"]["gbps"] for s in out]),
            "warm": _spread([s["warm"]["gbps"] for s in out])}
