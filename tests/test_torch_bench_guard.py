"""The port's bench around its windows, each in an interpreter that refuses
``jax`` (``tests/torch_nojax.py``): the one-JSON-line watchdog (a partial
line and exit 3 when no window completes, disarmed before the first
tick), the refusal to run without a card, the two read probes
(``read_profile``, ``sweep_lab``) over a tiny layout on the CPU, and the
checkpoint bench (``run_ckpt``) on a ``MiniCluster`` of five
chunkservers, the two it names stopped, through the reference's client
and through the port's. Counterpart of ``tests/test_bench_guard.py``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from torch_nojax import REPO, process_without_jax, run_without_jax


def test_watchdog_emits_partial_json_and_exits_hard():
    """No completed window for WEDGE_TIMEOUT_S: whatever was measured so
    far goes out as the one JSON line, and the process exits 3."""
    out = process_without_jax("""
        import time
        from tpudfs_torch import bench
        bench.WEDGE_TIMEOUT_S = 0.2
        bench.WEDGE_POLL_S = 0.05
        bench._partial.update({"write_pipeline_GBps": 0.123})
        bench._tick("unit-stage")
        bench._start_watchdog()
        time.sleep(30)  # the watchdog must end the process long before
    """, timeout=60)
    assert out.returncode == 3, (out.returncode, out.stderr[-2000:])
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["platform"] == "gpu-wedged-midrun(unit-stage)"
    assert line["write_pipeline_GBps"] == 0.123
    for k in ("metric", "value", "unit", "vs_baseline"):
        assert k in line, k


def test_watchdog_disarmed_without_tick():
    out = process_without_jax("""
        import time
        from tpudfs_torch import bench
        bench.WEDGE_TIMEOUT_S = 0.1
        bench.WEDGE_POLL_S = 0.02
        bench._start_watchdog()
        time.sleep(0.5)
        print("alive")
    """, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "alive", out.stderr


def test_bench_main_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-m", "tpudfs_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_read_probes_on_a_tiny_layout(tmp_path):
    r = run_without_jax(f"""
        import asyncio
        from pathlib import Path
        import torch
        from tpudfs_torch import bench, read_profile, sweep_lab
        bench.FILES, bench.BLOCK_BYTES, bench.REPS = 6, 65536, 1
        client = bench.lay_out_sets(Path({str(tmp_path)!r}))
        paths = [bench.file_path(0, i) for i in range(6)]
        cpu = torch.device("cpu")
        prof = asyncio.run(read_profile.profile(client, cpu, paths))
        lab = asyncio.run(sweep_lab.lab(client, cpu, paths, 3))
        result = {{"prof": prof, "lab": lab}}
    """)
    assert r["loaded_jax"] == []
    prof = r["prof"]
    assert (prof["files"], prof["bytes"]) == (6, 6 * 65536)
    assert prof["meta"]["files_per_s"] > 0
    for stage in ("disk", "h2d", "full", "fused"):
        assert prof[stage]["gbps"] > 0, stage
    # The fused stage went through the combiner: 6 blocks in rounds of
    # powers of two.
    assert (prof["fused"]["rounds"], prof["fused"]["blocks"]) == (2, 6)
    lab = r["lab"]
    assert lab["files"] == 6 and len(lab["sweeps"]) == 3
    for s in lab["sweeps"]:
        for kind in ("cold", "warm"):
            assert s[kind]["gbps"] > 0 and s[kind]["rounds"] == 2, s
            assert set(s[kind]["stage_s"]) == {"alloc", "pread", "upload",
                                               "copy_wait"}
    colds = [s["cold"]["gbps"] for s in lab["sweeps"]]
    assert lab["cold"]["win"] == [min(colds), max(colds)]
    assert sorted(colds)[1] == lab["cold"]["median"]


@pytest.mark.parametrize("device,client", [
    pytest.param(None, "reference", id="None"),
    pytest.param("cpu", "reference", id="cpu"),
    pytest.param(None, "port", id="None-port"),
    pytest.param("cpu", "port", id="cpu-port"),
])
def test_ckpt_bench_restores_healthy_and_with_two_chunkservers_dead(
        tmp_path, device, client):
    """``run_ckpt`` with the reference's client and with the port's
    (``tpudfs_torch.client.client``), on the same kind of cluster. The
    two chunkservers it names (the holders of the most data shards of its
    EC-only checkpoint) are stopped; each degraded restore rebuilds every
    block that lost a data shard (the plain twin on the CPU)."""
    if device is None and not torch.cuda.is_available():
        # The default device is the card: without one, run_ckpt refuses
        # before it reaches the cluster, and never restores to the host.
        r = run_without_jax("""
            import asyncio
            from tpudfs_torch import bench
            try:
                asyncio.run(bench.run_ckpt(None, None))
            except RuntimeError as e:
                result = {"error": str(e)}
        """)
        assert r["loaded_jax"] == []
        assert "no CUDA device" in r["error"]
        return
    r = run_without_jax(f"""
        import asyncio
        from pathlib import Path
        from tests.test_master_service import MiniCluster
        from tpudfs.client.client import Client as RefClient
        from tpudfs_torch.client.client import Client as PortClient
        from tpudfs_torch import bench
        bench.CKPT_TREE_KIB, bench.REPS = 64, 2

        async def main():
            c = MiniCluster(Path({str(tmp_path)!r}), n_masters=1, n_cs=5)
            await c.start()
            try:
                await c.wait_out_of_safe_mode(await c.leader())
                if {client!r} == "port":
                    client = PortClient(list(c.masters), block_size=65536,
                                        etag_mode="crc64")
                else:
                    client = RefClient(list(c.masters), rpc_client=c.client,
                                       block_size=65536, etag_mode="crc64")

                async def kill_two(victims):
                    assert len(victims) == 2
                    for i, cs in enumerate(c.chunkservers):
                        if cs.address in victims:
                            c.heartbeats[i].stop()
                            await cs.stop()

                try:
                    return await bench.run_ckpt(client, kill_two, {device!r})
                finally:
                    if {client!r} == "port":
                        await client.close()
            finally:
                await c.stop()

        result = asyncio.run(main())
    """, timeout=150)
    assert r["loaded_jax"] == []
    assert r["restored_to"] == (device or "cuda:0")
    assert (r["windows"], r["ckpt_shards"], r["ckpt_steps"]) == (2, 4, 3)
    for key in ("ckpt_save_GBps", "ckpt_restore_GBps",
                "ckpt_restore_degraded_GBps", "plain_write_GBps"):
        assert r[key] > 0, key
    assert r["ckpt_logical_bytes_per_step"] > 4 * 64 * 1024 * 0.75
    assert r["etag_mode"] == "crc64"
    assert r["platform"] == ("cpu" if device == "cpu" else "gpu")
    assert len(r["ckpt_degraded_victims"]) == 2
    assert r["ckpt_degraded_rebuilds"] \
        == r["ckpt_degraded_blocks_lost_data"] > 0
    if device == "cpu":
        assert r["ckpt_degraded_gf256_launches"] == 0  # the plain twin
    else:
        assert r["ckpt_degraded_gf256_launches"] \
            >= r["ckpt_degraded_rebuilds"]
