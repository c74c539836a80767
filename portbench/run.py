"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on stdout: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the reference compared,
with its limit, which also end standard error. Exits 2, printing no
result, without as many CUDA cards as the cell asks for, and 3 if a
module of JAX or of the JAX package is loaded once the window has closed.
Exits 4, printing no result, where the card's memory peak passed
``MEMORY_SHARE`` of the card: a leak, not a rate, would then set the
numbers.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names that must never be loaded in a run.
FOREIGN = ("jax", "jaxlib", "flax", "tpudfs")
#: The caches of the libraries the port runs on, at fixed paths inside the
#: checkout, so that only a checkout's first run builds into them.
CACHES = {"CUDA_CACHE_PATH": "cuda", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}
#: The share of the card's memory that a run's peak may reach. Past it,
#: device memory has grown with the window's work; a run nearer the card's
#: end measures an allocator under pressure, or stops out of memory.
MEMORY_SHARE = 0.85


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is foreign."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def memory_fault(peak: int, total: int) -> str | None:
    """Why a run whose memory peak is ``peak`` bytes of a card of
    ``total`` must print no result, or None where the peak is in bounds."""
    if peak <= MEMORY_SHARE * total:
        return None
    return (f"portbench: memory_peak_bytes {peak} is over "
            f"{MEMORY_SHARE:.0%} of the card's {total} bytes. Device memory "
            f"grew with the window's work: a degraded restore's tensors "
            f"outlive it while restore_shard_device keeps the hot copy's "
            f"read error, whose traceback holds the function's frame, until "
            f"Python's cyclic collector runs (PERF.md, Open questions). Free "
            f"them in the program; a faster restore reaches this sooner.")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, fault: str | None = None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench-cache" / sub)
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
              f"found {found}", file=sys.stderr)
        return 2
    from portbench.harness import run_cell

    result, checks = run_cell(
        bench, args.workload, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=torch.device("cuda", 0),
        t_start=T_START, fault=fault)
    fault_text = memory_fault(result["device"]["memory_peak_bytes"],
                              torch.cuda.get_device_properties(0).total_memory)
    if fault_text:
        print(fault_text, file=sys.stderr)
        return 4
    foreign = foreign_modules()
    if foreign:
        print(f"portbench: modules loaded that the port must not load: "
              f"{foreign}", file=sys.stderr)
        return 3
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
