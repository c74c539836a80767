"""Design probe for the GF(2^8) kernel, on one CUDA card:

    python3 -m tpudfs_torch.gpu.probe_gf256 [--words 2796224] [--seed 0]
        [--baseline path/to/other/gf256.cu ...] [--sass-dir DIR]

Times, on the same random shards (by default one 64 MiB block's RS(6,3)
shards, 2,796,224 words each), RS(6,3) decode with shards 0, 2 and 7 lost
(6 rows out) and RS(6,3) encode (3 rows out) through ``gf256.cu`` (nibble
tables in shared memory, addresses OR-ed into the table's base: the kept
design, ``nibble_tables``) and the variants of ``csrc/gf256_probe.cu``:
the bit-plane select-XOR of the kernel's first version with the number of
rows a template parameter (``select_xor_rows_template``); the nibble tables
indexed in C++ (``nibble_add_address``, an address add per nibble), with
both row groups in one 64-bit lookup (``*_pairs_lds64``), and as
``gf256.cu`` computes them under other grids (``nibble_or_address*``); and
the memory side alone (``loads_*``: the input rows read and the output rows
written, no arithmetic; unchecked). ``_rN`` names a grid of N words of 4 a
thread, the rest as many blocks as the card holds at once. ``--baseline``
(repeatable) adds another ``gf256.cu`` with the same C entry, built beside
the current one and named by its file name (the first version's:
``git show 058d1a7:tpudfs_torch/gpu/csrc/gf256.cu > build/gf256_first.cu``).
Every variant but the loads alone is checked bit-exact against the plain
twin ``gf_rows_plain`` on the card.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line:
per case each variant's device time (``ms``: median of 25 CUDA-event
timings, the stream held so that the host's launch latency is hidden;
``kernels.time_ms``), its time per single call (``call_ms``, that latency
included) and the byte bound at 3.35 TB/s; the compiler's register and
spill report per entry function; and, from ``cuobjdump -sass`` of each
built library, every loop of each kernel with its instruction
count by opcode (``--sass-dir`` also writes the whole listings there).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from tpudfs_torch.gpu import host_to_device, kernels
from tpudfs_torch.gpu.rs_cuda import (
    coef_bits,
    decode_matrix,
    gf_matmul_words,
    gf_rows_plain,
    matrix_bits_device,
)

HBM_BYTES_PER_S = 3.35e12
PROBE = "gf256_probe"
#: One 64 MiB block's RS(6,3) shard, padded to 128 bytes, in words.
MAIN_PATH_WORDS = -(-(-(-(64 << 20) // 6)) // 128) * 128 // 4


def _any(rows, cols):
    return True


def _two_groups(rows, cols):
    return 5 <= rows <= 8


#: (name, variant of ``tpudfs_gf256_probe``, rounds, checked, shapes it
#: takes): ``_rN`` names a grid of N words of 4 a thread, the rest as many
#: blocks as the card holds at once.
PROBE_VARIANTS = [
    ("select_xor_rows_template", 0, 0, True, _any),
    ("loads_stores_only", 1, 0, False, _any),
    ("loads_stores_only_r1", 1, 1, False, _any),
    ("loads_all_rows_first", 2, 0, False, _any),
    ("loads_all_rows_first_r1", 2, 1, False, _any),
    ("nibble_add_address", 3, 0, True, _any),
    ("nibble_add_address_pairs_lds64", 4, 0, True, _two_groups),
    ("nibble_or_address_pairs_lds64", 5, 0, True, _two_groups),
    ("nibble_or_address", 6, 0, True, _any),
    ("nibble_or_address_r1", 6, 1, True, _any),
    ("nibble_or_address_r2", 6, 2, True, _any),
]


def ptxas_lines(report: str) -> list[str]:
    return [ln.strip() for ln in report.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*\.(L_x_\d+):")
_TARGET = re.compile(r"\bBRA\b[^`(]*(?:`\(\.)?(L_x_\d+|0x[0-9a-f]+)")
_PRED = re.compile(r"^@!?\w+\s+")


def sass_loops(listing: str) -> dict[str, list[dict]]:
    """The loops of each function of a ``cuobjdump -sass`` listing: a loop
    is a backward branch and the instructions from its target to it; an
    innermost one holds no other. Each with its instruction count, the
    count by opcode (modifiers dropped) and how many are predicated."""
    funcs: dict[str, list] = {}
    name = None
    for line in listing.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
            continue
        if name is None:
            continue
        label = _LABEL.match(line)
        if label:
            funcs[name].append(("label", label.group(1)))
            continue
        insn = _INSN.search(line)
        if insn:
            funcs[name].append(("insn", int(insn.group(1), 16),
                                insn.group(2).strip()))
    out = {}
    for fname, items in funcs.items():
        insns, labels, pending = [], {}, []
        for item in items:
            if item[0] == "label":
                pending.append(item[1])
            else:
                for lab in pending:
                    labels[lab] = item[1]
                pending = []
                insns.append(item[1:])
        loops = []
        for addr, text in insns:
            m = _TARGET.search(text)
            if not m:
                continue
            tgt = m.group(1)
            start = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
            if start is not None and start <= addr:
                loops.append((start, addr))
        rows = []
        for start, end in sorted(set(loops)):
            body = [t for a, t in insns if start <= a <= end]
            ops = Counter(_PRED.sub("", t).split()[0].split(".")[0]
                          for t in body)
            rows.append({"start": hex(start), "end": hex(end),
                         "innermost": not any(
                             (s, e) != (start, end) and start <= s
                             and e <= end for s, e in loops),
                         "instructions": len(body),
                         "predicated": sum(t.startswith("@") for t in body),
                         "opcodes": dict(ops.most_common())})
        out[fname] = rows
    return out


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(kernels._nvcc()).with_name("cuobjdump"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=MAIN_PATH_WORDS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", type=Path, action="append", default=[])
    ap.add_argument("--sass-dir", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_gf256: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    info = kernels.build(["gf256", PROBE])
    probe = kernels.lib(PROBE).tpudfs_gf256_probe
    probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    libs = {n: Path(i["so"]) for n, i in info.items()}
    reports = {n: i["ptxas"] for n, i in info.items()}
    baselines = {}
    for src in args.baseline:
        handle, libs[src.stem], reports[src.stem] = kernels.build_other(src)
        fn = handle.tpudfs_gf256_matmul
        fn.argtypes = kernels._SIGNATURES["gf256"]["tpudfs_gf256_matmul"]
        fn.restype = ctypes.c_int
        baselines[src.stem] = fn

    w = args.words
    g = torch.Generator(device=dev).manual_seed(args.seed)
    shards = torch.randint(-(1 << 31), 1 << 31, (6, w), dtype=torch.int32,
                           device=dev, generator=g).view(torch.uint32)
    cases = {
        "decode_6_3": matrix_bits_device(
            decode_matrix(6, 3, (1, 3, 4, 5, 6, 8)), dev),
        "encode_6_3": host_to_device(coef_bits(6, 3), dev),
    }
    result = {"phase": "probe_gf256", "card": torch.cuda.get_device_name(0),
              "words": w, "timer": "cuda events, stream held, median of 25",
              "cases": {}}
    for label, coefs in cases.items():
        rows, cols, _ = coefs.shape
        out = torch.empty((rows, w), dtype=torch.int32, device=dev)

        def probe_variant(variant: int, rounds: int = 0, coefs=coefs, out=out):
            def run():
                kernels.check(PROBE, probe(
                    shards.data_ptr(), w, coefs.shape[0], coefs.shape[1],
                    coefs.data_ptr(), variant, rounds, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream))
            return run

        variants = {
            "nibble_tables": lambda coefs=coefs: gf_matmul_words(shards, coefs),
        }
        checked = []
        for name, variant, rounds, check, fits in PROBE_VARIANTS:
            if fits(rows, cols):
                variants[name] = probe_variant(variant, rounds)
                if check:
                    checked.append(name)
        for stem, fn in baselines.items():
            def base(fn=fn, coefs=coefs, out=out):
                kernels.check("gf256", fn(
                    shards.data_ptr(), w, coefs.shape[0], coefs.shape[1],
                    coefs.data_ptr(), out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream))
            variants[stem] = base
            checked.append(stem)
        want = gf_rows_plain(shards, coefs)
        if not torch.equal(gf_matmul_words(shards, coefs), want):
            raise AssertionError(f"{label}: gf256.cu differs from the plain twin")
        for name in checked:
            out.zero_()
            variants[name]()
            if not torch.equal(out.view(torch.uint32), want):
                raise AssertionError(f"{label}: {name} differs from the plain twin")
        nbytes = (cols + rows) * w * 4 + coefs.numel() * 4
        result["cases"][label] = {
            "rows": rows, "cols": cols,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ms": {n: kernels.time_ms(f) for n, f in variants.items()},
            "call_ms": {n: kernels.time_ms(f, held=False)
                        for n, f in variants.items()},
        }
    result["ptxas"] = {n: ptxas_lines(r) for n, r in reports.items()}
    result["sass"] = {}
    for name, so in libs.items():
        listing = subprocess.run([cuobjdump(), "-sass", str(so)], check=True,
                                 capture_output=True, text=True).stdout
        if args.sass_dir is not None:
            args.sass_dir.mkdir(parents=True, exist_ok=True)
            (args.sass_dir / f"{name}.sass").write_text(listing)
        result["sass"][name] = sass_loops(listing)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
