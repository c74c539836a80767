"""The port's slice as a whole, on the CPU at a small size: ``chip_smoke.py``'s
read path (replicated, tail and degraded RS(6,3) blocks, one confirm, a
tampered replica flagged and recovered), its batched phases (the read
combiner, the native sweep pump, the infeed) and its write side (the
collective write group with a tampered round, the RS(6,3) scatter and
gather on a 9-position ring, the write step's parity), the graft entry
points (the entry step with a poisoned CRC, the dryrun on 8 and 9
positions), its checkpoint restore (healthy, a flipped replica, the whole
shard from the RS(3,2) cold copy) and dataset infeed, the bench phase (the
port's bench on local file sets and its two read probes), the cluster
phase (a live process cluster through the port's own client, in an
interpreter that refuses jax), the rule that the port and the smoke script
import neither jax nor ``tpudfs`` and load no library the JAX package
built, that only the port's client and launcher load ``grpc``, and the
script's refusal to run without a card."""

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
from torch_nojax import run_without_jax
from tpudfs_torch.client.local import LocalClient
from tpudfs_torch.gpu.checkpoint import CheckpointManager
from tpudfs_torch.gpu.hbm_reader import HbmReader
from tpudfs_torch.gpu.ici_replication import make_mesh
from tpudfs_torch.gpu.infeed import DfsInfeed
from tpudfs_torch.gpu.read_combiner import ReadCombiner
from tpudfs_torch.gpu.record_source import device_iterator, make_dataset
from tpudfs_torch.graft_entry import dryrun_multichip, entry, positions

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
                           "fallbacks": 3, "persisted": 0}
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


def test_entry_and_dryrun_phases_small_on_cpu():
    e = chip_smoke.entry_phase(CPU, chunks=96)
    assert (e["chunks"], e["bytes"]) == (96, 96 * 512)
    assert e["crc_ok"] and e["write_ok"] and e["write_acks"] == 1
    assert e["parity_shape"] == [3, 8192] and e["parity_exact"]
    assert e["tamper"] == {"crc_ok": False, "write_ok": False,
                           "write_acks": 0}
    assert e["step_ms"] > 0 and e["call_ms"] > 0
    d = chip_smoke.dryrun_phase(CPU, chunks_per_position=6)
    assert d["bytes_per_position"] == 3072 and set(d["runs"]) == {"8", "9"}
    r8, r9 = d["runs"]["8"], d["runs"]["9"]
    assert r8["mapping"] == "all 8 positions on cpu"
    assert (r8["ec"], r8["pod"]["shape"], r8["pod"]["ec"]) == \
        ([5, 3], [2, 4], [2, 2])
    assert (r9["ec"], r9["pod"]["shape"], r9["pod"]["ec"]) == \
        ([6, 3], [3, 3], [1, 2])
    for r, n in ((r8, 8), (r9, 9)):
        assert r["exact"] and r["write_acks"] == r["scatter_acks"] == n
        assert r["pod"]["acks"] == r["pod"]["scatter_acks"] == n
        assert r["gather_failed"] == 0
        assert set(r["seconds"]) == set(r["first_seconds"]) == {
            "inputs", "write", "scatter_gather", "pod"}
        assert r["peak_bytes"] is None  # no device memory on the CPU
        assert r["busy"] is None  # no card to trace
    assert (r8["pod"]["shard_bytes"], r9["pod"]["shard_bytes"]) == \
        (1536, 3072)
    no_launch = {"crc32c_chunks": 0, "crc32c_blocks": 0, "gf256_matmul": 0}
    assert e["launches"] == d["launches"] == no_launch


def test_leg_busy_counts_device_work_once_per_leg():
    """The dryrun's busy shares from a Chrome trace: device intervals
    clipped to each ``dryrun.<leg>`` range, overlapping streams counted
    once, host events and other ranges ignored; no device work at all is
    not measured."""
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        ev("user_annotation", "dryrun.write", 100, 100),
        ev("user_annotation", "dryrun.pod", 300, 50),
        ev("user_annotation", "other", 0, 1000),
        ev("kernel", "crc", 90, 30),  # 20 us inside write
        ev("gpu_memcpy", "Memcpy DtoD", 150, 20),
        ev("kernel", "gf", 160, 20),  # overlaps the copy: 10 us more
        ev("gpu_memset", "Memset", 195, 50),  # 5 us inside write
        ev("cpu_op", "aten::copy_", 100, 100),
        ev("kernel", "crc", 310, 10),
    ]
    legs = chip_smoke.leg_busy(events)
    assert set(legs) == {"write", "pod"}
    assert legs["write"]["span_ms"] == pytest.approx(0.1)
    assert legs["write"]["device_busy_ms"] == pytest.approx(0.055)
    assert legs["write"]["busy_share"] == pytest.approx(0.55)
    assert legs["pod"]["busy_share"] == pytest.approx(0.2)
    assert chip_smoke.leg_busy(events[:3] + events[7:8]) is None


def test_restore_and_dataset_small_on_cpu(tmp_path):
    r = chip_smoke.restore_path(CPU, params=40_000, block_size=65536,
                                workdir=tmp_path)
    # 3 x 160,000 B of fp32 states (aligned to 160,256), 13 int8 flags
    # (512), 80,000 B of bf16 weights (80,384) and the int64 step: 9
    # blocks, the last not 512-aligned.
    assert r["payload_bytes"] == 3 * 160_256 + 512 + 80_384 + 8
    assert (r["blocks"], r["tail_block_bytes"]) == (9, 561_672 - 8 * 65536)
    assert r["tensors"]["step"] == ["<i8", []]
    assert r["tensors"]["model"] == ["<V2", [40_000]]
    assert r["reduced"] == ["params_per_rank 40000 of 105312500",
                            "block_size 65536 of 67108864"]
    assert (r["rereads"], r["degraded_shard_reads"]) == (0, 0)
    assert (r["flipped"]["rereads"], r["flipped"]["degraded_shard_reads"]) \
        == (1, 0)
    assert r["degraded"]["degraded_shard_reads"] == 1
    assert set(r["stage_s"]) == {"read", "combined_crc", "assemble",
                                 "bounce", "bounce_copy", "bounce_crc"}
    assert set(r["setup_split_s"]) == {"hot_copy", "ec_encode", "ec_writes"}
    assert all(run["engine_calls"]["crc32c"] > 0
               for run in (r, r["first_run"]))
    assert r["exact"] and r["degraded_gbps"] > 0
    no_launch = {"crc32c_chunks": 0, "crc32c_blocks": 0, "gf256_matmul": 0}
    assert r["launches"] == no_launch
    d = chip_smoke.dataset_path(CPU, file_bytes=1 << 20, block_size=65536,
                                batches=20, num_workers=0, workdir=tmp_path)
    assert (d["records"], d["batches"], d["record_bytes"]) == (512, 20, 2048)
    assert d["exact"] and d["records_per_s"] > 0
    assert list(tmp_path.iterdir()) == []  # the stores are removed


def test_bench_phase_small_on_cpu(tmp_path, monkeypatch):
    """The bench phase at a small size: the local bench run, both read
    probes on set 0 of its layout, set 0 read back byte for byte, no
    launch counted on the CPU, the layout removed."""
    from tpudfs_torch import bench, read_profile

    for name, value in (("FILES", 8), ("BLOCK_BYTES", 65536), ("REPS", 2),
                        ("READ_REPS", 2), ("ICI_STEP_MB", 1),
                        ("ICI_REPS", 2)):
        monkeypatch.setattr(bench, name, value)
    monkeypatch.setattr(read_profile, "FILES", 4)
    r = chip_smoke.bench_phase(CPU, sweeps=2, workdir=tmp_path)
    assert (r["files"], r["sets"], r["block_bytes"]) == (8, 2, 65536)
    assert r["exact"] and r["result"]["remote"] is False
    assert r["result"]["windows"] == 2 and r["result"]["value"] > 0
    assert r["result"]["local_read_blocks"] == 2 * 8
    assert r["read_profile"]["files"] == 4
    assert set(r["read_profile"]) >= {"meta", "disk", "h2d", "full",
                                      "fused"}
    assert len(r["sweep_lab"]["sweeps"]) == 2
    assert r["launches"] == {"crc32c_chunks": 0, "crc32c_blocks": 0,
                             "gf256_matmul": 0}
    assert set(chip_smoke.PATH_KERNELS["bench"]) == set(r["launches"])
    assert list(tmp_path.iterdir()) == []  # the layout is removed


def test_cluster_phase_small_on_cpu(tmp_path):
    """The cluster phase at a small size in an interpreter that refuses
    jax: 1 master and 5 chunkserver processes, the writes, the three read
    paths over the wire (no block read off disk) and short-circuited (the
    pump serves every full block), both tampers caught by the layer named,
    two chunkservers SIGKILLed and every EC block that lost a data shard
    rebuilt; no ``tpudfs`` or ``jax`` module in the process."""
    r = run_without_jax(f"""
        from pathlib import Path
        import torch
        import chip_smoke
        result = chip_smoke.cluster_phase(
            torch.device("cpu"), block_size=65536, nblocks=4,
            tail_size=20_003, ec_blocks=2, workdir=Path({str(tmp_path)!r}))
    """, timeout=150)
    assert r["loaded_jax"] == [] and r["foreign_modules"] == []
    assert (r["masters"], r["chunkservers"]) == (1, 5)
    assert len(r["server_pids"]) == 6
    assert (r["nblocks"], r["ec"], r["ec_blocks"]) == (4, [3, 2], 2)
    for key in ("big_gbps", "tail_gbps", "ec_gbps"):
        assert r["write"][key] > 0, key
    for mode in ("wire", "short_circuit"):
        for path in ("per_block", "combined", "sweep"):
            assert r[mode][path]["gbps"] > 0, (mode, path)
    assert r["wire"]["local_read_blocks"] == 0
    assert r["wire"]["sweep"]["pump_blocks"] == 0
    assert r["short_circuit"]["sweep"]["pump_blocks"] == 4
    assert r["short_circuit"]["local_read_blocks"] > 0
    assert r["tamper"]["short_circuit"]["caught_by"].startswith("device CRC")
    assert r["tamper"]["wire"]["caught_by"].startswith("chunkserver")
    d = r["degraded"]
    assert len(d["victims"]) == 2 and d["blocks_lost_data"] >= 1
    assert d["rebuilt_blocks"] == d["blocks_lost_data"]
    assert d["gf256_launches"] == 0  # the plain twin on the CPU
    assert list(tmp_path.iterdir()) == []  # the cluster's dirs are removed


def test_only_the_client_and_launcher_load_grpc():
    """``import tpudfs_torch``, its device modules, the bench and the
    launcher load no ``grpc``; the port's client does."""
    code = """
import sys
import tpudfs_torch
import tpudfs_torch.gpu.hbm_reader, tpudfs_torch.gpu.read_combiner
import tpudfs_torch.gpu.checkpoint, tpudfs_torch.gpu.record_source
import tpudfs_torch.gpu.wds, tpudfs_torch.gpu.infeed
import tpudfs_torch.common.resilience, tpudfs_torch.common.sharding
import tpudfs_torch.client.local, tpudfs_torch.bench, tpudfs_torch.cluster
import tpudfs_torch.netem, tpudfs_torch.helm_chaos
import chip_smoke
before = sorted(m for m in sys.modules if m.split(".")[0] == "grpc")
import tpudfs_torch.client.client
after = "grpc" in sys.modules and "msgpack" in sys.modules
print(before, after)
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] True"


def test_restore_phase_rejects_a_wrong_tensor(tmp_path, monkeypatch):
    """The restore phase fails loudly when a restored tensor differs."""
    real = chip_smoke.restore_shard_device

    async def flip(*args, **kwargs):
        out = await real(*args, **kwargs)
        out["flags"] = out["flags"] ^ 1
        return out

    monkeypatch.setattr(chip_smoke, "restore_shard_device", flip)
    with pytest.raises(AssertionError, match="flags"):
        chip_smoke.restore_path(CPU, params=4000, block_size=8192,
                                workdir=tmp_path)


def test_restore_phase_rejects_bf16_bits_under_another_dtype(tmp_path,
                                                            monkeypatch):
    """The restore phase fails loudly when the bf16 weights come back with
    the right bits under another 2-byte dtype."""
    real = chip_smoke.restore_shard_device

    async def as_f16(*args, **kwargs):
        out = await real(*args, **kwargs)
        out["model"] = out["model"].view(torch.float16)
        return out

    monkeypatch.setattr(chip_smoke, "restore_shard_device", as_f16)
    with pytest.raises(AssertionError, match="model is torch.float16"):
        chip_smoke.restore_path(CPU, params=4000, block_size=8192,
                                workdir=tmp_path)


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
chip_smoke.entry_phase(torch.device("cpu"), chunks=96)
chip_smoke.dryrun_phase(torch.device("cpu"), chunks_per_position=6)
import tpudfs_torch.gpu.torch_data, tpudfs_torch.gpu.wds
import tpudfs_torch.ici_roulette
import tpudfs_torch.ckpt_chaos
chip_smoke.restore_path(torch.device("cpu"), workdir=Path({str(tmp_path)!r}),
                        params=3000, block_size=4096)
chip_smoke.dataset_path(torch.device("cpu"), workdir=Path({str(tmp_path)!r}),
                        file_bytes=131072, block_size=16384, batches=3,
                        num_workers=0)
from tpudfs_torch import bench, read_profile
bench.FILES, bench.BLOCK_BYTES, bench.REPS, bench.READ_REPS = 8, 16384, 1, 1
bench.ICI_STEP_MB, bench.ICI_REPS, read_profile.FILES = 1, 1, 4
chip_smoke.bench_phase(torch.device("cpu"), sweeps=1,
                       workdir=Path({str(tmp_path)!r}))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "tpudfs" or m.startswith("tpudfs."))
assert not bad, bad
for m in ("hbm_reader", "read_combiner", "infeed", "ici_replication",
          "write_group", "checkpoint", "record_source", "torch_data", "wds"):
    assert "tpudfs_torch.gpu." + m in sys.modules, m
assert "tpudfs_torch.graft_entry" in sys.modules
assert "tpudfs_torch.chunkserver.ici_member" in sys.modules
assert "tpudfs_torch.ici_roulette" in sys.modules
assert "tpudfs_torch.ckpt_chaos" in sys.modules
for m in ("bench", "read_profile", "sweep_lab"):
    assert "tpudfs_torch." + m in sys.modules, m
assert "tpudfs_torch.common.layout" in sys.modules
assert "tpudfs_torch.common.native" in sys.modules
assert "tpudfs_torch.common.ckptpaths" in sys.modules
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
                 "gpu/ici_replication.py", "gpu/write_group.py",
                 "common/ckptpaths.py", "gpu/checkpoint.py",
                 "gpu/record_source.py", "gpu/torch_data.py", "gpu/wds.py",
                 "graft_entry.py", "chunkserver/ici_member.py",
                 "ici_roulette.py", "bench.py", "read_profile.py",
                 "sweep_lab.py", "common/layout.py", "ckpt_chaos.py",
                 "client/client.py", "cluster.py", "common/rpc.py",
                 "common/resilience.py", "common/sharding.py",
                 "common/blocknet.py", "common/writestream.py", "pki.py",
                 "netem.py"):
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
        assert list(device_iterator([torch.zeros(2)]))[0].is_cuda
        assert all(d.type == "cuda" for d in positions(3))
        assert entry()[1][0].is_cuda
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
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_iterator([])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_iterator([], "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_dataset(range(4), batch_size=2)
        mgr = CheckpointManager(client, "/b", num_shards=1,
                                reader=HbmReader(client, [CPU]))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            asyncio.run(mgr.restore(device="cuda"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            positions(3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(8)
        from tpudfs_torch import bench
        for run in (bench.run_remote, bench.run_remote_ckpt):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                run(None, tmp_path / "never")
        assert not (tmp_path / "never").exists()  # nothing was spawned
        from tpudfs_torch import bench, ckpt_chaos, read_profile, sweep_lab
        reader = HbmReader(client, [CPU])
        for run in (bench.run_against(client, remote=False),
                    bench.run_ckpt(client, lambda victims: None),
                    read_profile.profile(client, paths=["/f"]),
                    sweep_lab.lab(client, paths=["/f"]),
                    ckpt_chaos.kill_mid_checkpoint(
                        client, lambda: None, lambda: None, base="/c",
                        kib=1, reader=reader),
                    ckpt_chaos.settle_and_verify(
                        ckpt_chaos.roulette_manager(client, reader=reader),
                        1, set(), kib=1),
                    ckpt_chaos.rebuild_after_kills(
                        client, lambda v: None, base="/c", kib=1,
                        reader=reader)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                asyncio.run(run)
    assert HbmReader(client, [CPU]).devices == [CPU]
    assert ReadCombiner(client, CPU).device == CPU
    assert DfsInfeed(client, [], [CPU]).reader.devices == [CPU]
    assert list(device_iterator([torch.zeros(2)], CPU))[0].device == CPU
    assert positions(3, CPU) == [CPU] * 3
    assert entry(CPU)[1][0].device == CPU
