"""The port's slice as a whole, on the CPU at a small size: ``chip_smoke.py``'s
read path (replicated, tail and degraded RS(6,3) blocks, one confirm, a
tampered replica flagged and recovered), its batched phases (the read
combiner, the native sweep pump, the infeed) and its write side (the
collective write group with a tampered round, the RS(6,3) scatter and
gather on a 9-position ring, the write step's parity), the rule that the
port and the smoke script import neither jax nor ``tpudfs`` and load no
library the JAX package built, and the script's refusal to run without a
card."""

import ast
import asyncio
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpudfs_torch.client.local import LocalClient
from tpudfs_torch.gpu.hbm_reader import HbmReader
from tpudfs_torch.gpu.ici_replication import make_mesh
from tpudfs_torch.gpu.infeed import DfsInfeed
from tpudfs_torch.gpu.read_combiner import ReadCombiner

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = dict(block_size=64 * 1024, nblocks=4, tail_size=20_003)


def test_read_path_small_on_cpu(tmp_path):
    r = chip_smoke.read_path(CPU, workdir=tmp_path, **SMALL)
    assert r["read_bytes"] == 4 * 64 * 1024
    assert r["blocks"] == 6  # 4 replicated + 1 tail + 1 EC
    assert r["pending_at_confirm"] == 5  # the tail block verifies eagerly
    assert r["tail_block_bytes"] == 20_003
    assert r["tamper"] == {"block": "blk_smoke_big_2", "flagged": True,
                           "recovered": True}
    # The CPU path runs the plain twins: no kernel launch is counted.
    assert r["launches"] == {"crc32c_chunks": 0, "crc32c_blocks": 0,
                             "gf256_matmul": 0}
    # The batched phases on the same stores: one round of 4 per pass (the
    # CPU device verifies inside the native pread), the tail block outside
    # the sweep pump, every tamper check recovered, no launch counted.
    comb = r["combined"]
    assert comb["host_verify"] is True
    assert (comb["rounds"], comb["blocks"]) == (1, 4)
    assert (comb["first_pass"]["rounds"], comb["first_pass"]["blocks"]) == (1, 4)
    assert comb["tamper"]["recovered"] and comb["pooled_buffers"] >= 1
    assert r["sweep"]["sweep_blocks"] == 4
    assert r["sweep"]["read_bytes"] == 4 * 64 * 1024 + 20_003
    assert r["sweep"]["tamper"]["recovered"]
    assert r["infeed"]["files"] == 2
    for phase in ("combined", "sweep", "infeed"):
        assert r[phase]["launches"] == r["launches"]
    assert list(tmp_path.iterdir()) == []  # the layout is removed


def test_write_side_small_on_cpu(tmp_path):
    w = chip_smoke.write_path(CPU, workdir=tmp_path, block_size=16384,
                              nblocks=2)
    assert w["mapping"] == "all 3 positions on cpu"
    assert w["devices"] == ["cpu"] * 3 and w["replication"] == 3
    # One round of B=2 a pass; every store read back 3 copies per block.
    assert (w["rounds"], w["acks"]) == (1, 3)
    assert (w["first_pass"]["rounds"], w["first_pass"]["acks"]) == (1, 3)
    assert w["copies_read_back"] == 3 * 3 * 2
    assert w["bytes"] == 3 * 2 * 16384 and w["blocks"] == 12
    assert set(w["stage_s"]) == {"stage", "h2d", "replicate", "acks",
                                 "drain", "persist"}
    assert w["tamper"] == {"acks": 0, "round_failures": 1,
                           "futures_failed": 3, "persisted": 0}
    assert (w["round_failures"], w["persist_failures"]) == (1, 0)
    assert set(w["host"]) == {"bytes", "d2h_pageable_gbps", "cut_gbps",
                              "persist_one_block_s"}  # no pinned copy on CPU
    ec = chip_smoke.ec_collective(CPU, block_size=16384)
    assert ec["mapping"] == "all 9 positions on cpu"
    assert ec["scatter_acks"] == 9 and ec["exact"]
    assert ec["shard_bytes"] == 3072  # ceil(16384 / 6) in whole chunks
    assert ec["write_step"] == {"devices": ["cpu"] * 3, "acks": 3,
                                "parity_exact": True}
    no_launch = {"crc32c_chunks": 0, "crc32c_blocks": 0, "gf256_matmul": 0}
    assert w["launches"] == ec["launches"] == no_launch
    assert ec["gf256_launches"] == {"encode": 0, "decode": 0}
    assert list(tmp_path.iterdir()) == []  # the stores are removed


def test_read_path_rejects_a_broken_layout(tmp_path, monkeypatch):
    """The smoke fails loudly when a read comes back wrong."""
    real = chip_smoke.device_array_to_bytes

    def flip(arr, size):
        out = bytearray(real(arr, size))
        out[0] ^= 1
        return bytes(out)

    monkeypatch.setattr(chip_smoke, "device_array_to_bytes", flip)
    with pytest.raises(AssertionError, match="bytes differ"):
        chip_smoke.read_path(CPU, workdir=tmp_path, **SMALL)


def test_port_and_smoke_import_neither_jax_nor_tpudfs(tmp_path):
    code = f"""
import sys
import chip_smoke
import tpudfs_torch.gpu.state, tpudfs_torch.gpu.kernels
from pathlib import Path
import torch
chip_smoke.read_path(torch.device("cpu"), workdir=Path({str(tmp_path)!r}),
                     block_size=16384, nblocks=2, tail_size=5000)
chip_smoke.write_path(torch.device("cpu"), workdir=Path({str(tmp_path)!r}),
                      block_size=4096, nblocks=1)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "tpudfs" or m.startswith("tpudfs."))
assert not bad, bad
for m in ("hbm_reader", "read_combiner", "infeed", "ici_replication",
          "write_group"):
    assert "tpudfs_torch.gpu." + m in sys.modules, m
assert "tpudfs_torch.common.native" in sys.modules
# The block I/O engine is the port's own build, not the JAX package's.
maps = Path("/proc/self/maps").read_text()
assert "build/tpudfs_torch/libtpudfs_blockio-" in maps
assert "libtpudfs_native" not in maps
print("clean")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_sources_name_no_jax_or_tpudfs_import():
    files = sorted((REPO / "tpudfs_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 15
    for name in ("common/native.py", "gpu/read_combiner.py", "gpu/infeed.py",
                 "gpu/ici_replication.py", "gpu/write_group.py"):
        assert REPO / "tpudfs_torch" / name in files, name
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "tpudfs"), f"{f}: {name}"


def test_chip_smoke_without_a_card_fails_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # Alone in a directory, without the package, it fails as well.
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_default_to_cuda(tmp_path):
    client = LocalClient({}, {})
    if torch.cuda.is_available():
        assert make_mesh().positions()[0].type == "cuda"
        assert HbmReader(client).devices[0].type == "cuda"
        assert ReadCombiner(client).device.type == "cuda"
        assert DfsInfeed(client, []).reader.devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HbmReader(client)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ReadCombiner(client)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DfsInfeed(client, ["/f"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            asyncio.run(HbmReader(client, [CPU]).sweep_metas_to_device(
                [], torch.device("cuda")))
    assert HbmReader(client, [CPU]).devices == [CPU]
    assert ReadCombiner(client, CPU).device == CPU
    assert DfsInfeed(client, [], [CPU]).reader.devices == [CPU]
