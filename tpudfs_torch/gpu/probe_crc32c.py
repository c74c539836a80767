"""Design probe for the CRC32C kernel, on one CUDA card:

    python3 -m tpudfs_torch.gpu.probe_crc32c [--chunks 131072] [--seed 0]
        [--baseline path/to/other/crc32c.cu ...]

Times, on the same random chunk grid (one 64 MiB block by default):
``crc32c.cu``'s per-chunk kernel (positional nibble tables, a warp per
chunk), its fused whole-block kernel, and the textbook slice-by-8 CRC32C
with one lane per chunk (``csrc/crc32c_slice8_probe.cu``), loading each
lane's chunk straight from device memory or staged through shared memory;
and the memory side alone (``loads_only_*``: a warp per chunk, no table
lookups, in ``crc32c.cu``'s order and others; unchecked, they compute no
CRC). Also reports where dynamic shared memory starts (``smem_base``).
``--baseline`` (repeatable) adds another ``crc32c.cu`` with the same
C entries (from a checkout of an earlier commit), built beside the current
one and named by its file name; its fused entry is timed where it has one. Every variant's CRCs are checked against the per-chunk kernel's. Prints the
card's ``nvidia-smi`` name and power limit, then one JSON line with each
variant's device time (``ms``: median of 25 CUDA-event timings, the stream
held so that the host's launch latency is hidden; ``kernels.time_ms``) and
its time per single call (``call_ms``, that latency included), the byte
bound at 3.35 TB/s, and the compiler's register report.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tpudfs_torch.common.checksum import _byte_table
from tpudfs_torch.gpu import host_to_device, kernels, u32_to_numpy
from tpudfs_torch.gpu.crc32c_cuda import (
    crc32c_blocks_device,
    crc32c_chunks_device,
    fold_ops,
    inv_contrib,
    word_contrib_table,
)

HBM_BYTES_PER_S = 3.35e12
PROBE = "crc32c_slice8_probe"


def slice8_tables() -> np.ndarray:
    """(8, 256) uint32: T_k[b] = register after byte b and k zero bytes."""
    t = np.empty((8, 256), dtype=np.uint32)
    t[0] = _byte_table()
    for k in range(1, 8):
        t[k] = (t[k - 1] >> np.uint32(8)) ^ t[0][t[k - 1] & 0xFF]
    return t


def build_baseline(src: Path) -> tuple[dict, str]:
    """Another crc32c.cu as its own library: its bound C entries (the ones
    it has) and the compiler's report."""
    handle, _, report = kernels.build_other(src)
    fns = {}
    for symbol, argtypes in kernels._SIGNATURES["crc32c"].items():
        if hasattr(handle, symbol):
            fns[symbol] = getattr(handle, symbol)
            fns[symbol].argtypes = argtypes
            fns[symbol].restype = ctypes.c_int
    return fns, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, default=131072)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", type=Path, action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_crc32c: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    info = kernels.build(["crc32c", PROBE])
    probe = kernels.lib(PROBE)
    fn = probe.tpudfs_crc32c_slice8_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    c = args.chunks
    g = torch.Generator(device=dev).manual_seed(args.seed)
    words = torch.randint(-(1 << 31), 1 << 31, (c, 128), dtype=torch.int32,
                          device=dev, generator=g).view(torch.uint32)
    tables = host_to_device(slice8_tables(), dev)
    out = torch.empty(c, dtype=torch.int32, device=dev)

    def probe_variant(variant: int):
        def run():
            rc = fn(words.data_ptr(), c, tables.data_ptr(), variant,
                    out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            kernels.check(PROBE, rc)
        return run

    variants = {
        "nibble_warp_per_chunk": lambda: crc32c_chunks_device(words),
        "nibble_fused_block": lambda: crc32c_blocks_device(words, 1),
        "slice8_lane_per_chunk_direct": probe_variant(0),
        "slice8_lane_per_chunk_staged": probe_variant(1),
        "loads_only_tiles_4_ahead": probe_variant(2),
        "loads_only_tiles_8_ahead": probe_variant(3),
        "loads_only_strided_4_ahead": probe_variant(4),
        "loads_only_strided_8_ahead": probe_variant(5),
        "loads_only_tiles_4_ahead_down": probe_variant(6),
        # What a 4-byte memset costs on a held stream (the fused entry zeroes
        # its output before its launch).
        "memset_4_bytes": lambda: out[:1].zero_(),
    }
    checked = ["slice8_lane_per_chunk_direct", "slice8_lane_per_chunk_staged"]
    wcontrib = host_to_device(word_contrib_table(), dev)
    ops = host_to_device(fold_ops(), dev)
    fx = inv_contrib() ^ 0xFFFFFFFF
    reports = {}
    for src in args.baseline:
        fns, reports[src.stem] = build_baseline(src)

        def chunks(fn=fns["tpudfs_crc32c_chunks"]):
            kernels.check("crc32c", fn(
                words.data_ptr(), c, wcontrib.data_ptr(), fx, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream))

        variants[f"{src.stem}_chunks"] = chunks
        checked.append(f"{src.stem}_chunks")
        if "tpudfs_crc32c_blocks" in fns:
            def blocks(fn=fns["tpudfs_crc32c_blocks"]):
                kernels.check("crc32c", fn(
                    words.data_ptr(), 1, c, wcontrib.data_ptr(), fx,
                    ops.data_ptr(), 0, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream))

            variants[f"{src.stem}_blocks"] = blocks
            blocks()
            if u32_to_numpy(out[:1].view(torch.uint32))[0] != u32_to_numpy(
                    crc32c_blocks_device(words, 1))[0]:
                raise AssertionError(f"{src.stem}_blocks differs")
    want = u32_to_numpy(crc32c_chunks_device(words))
    for name in checked:
        out.zero_()
        variants[name]()
        if not np.array_equal(u32_to_numpy(out.view(torch.uint32)), want):
            raise AssertionError(f"{name} differs from crc32c_chunks")
    probe_variant(9)()
    smem_base = int(u32_to_numpy(out[:1].view(torch.uint32))[0])
    nbytes = c * 512 + c * 4
    result = {"phase": "probe_crc32c", "chunks": c,
              "card": torch.cuda.get_device_name(0),
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
              "smem_base": smem_base,
              "timer": "cuda events, stream held, median of 25",
              "ms": {name: kernels.time_ms(f) for name, f in variants.items()},
              "call_ms": {name: kernels.time_ms(f, held=False)
                          for name, f in variants.items()},
              "ptxas": {name: [ln for ln in report.splitlines()
                               if "registers" in ln or "spill" in ln]
                        for name, report in {
                            **{n: i["ptxas"] for n, i in info.items()},
                            **reports}.items()}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
