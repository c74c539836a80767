"""The port's bench (``tpudfs_torch.bench``) on the CPU, at a small size,
against the JAX package's ``bench.py``: the device write step and the
RS(6,3) scatter step window for window (the same sample count, verdicts
and bytes; a wrong CRC word fails both write steps alike, and a failed
step verdict fails the run), the read windows over file sets laid out on local disk (every
landed block equal to its source bytes, every verdict confirmed, a flipped
replica recovered, a block with every replica flipped failing the run),
and the remote windows against the reference ``Client`` on an in-process
``MiniCluster`` (every result key of ``bench.py`` that the port keeps)."""

import asyncio
import types

import numpy as np
import pytest
import torch

import bench as ref_bench
from tests.test_master_service import MiniCluster
from tpudfs.client.client import Client
from tpudfs_torch import bench
from tpudfs_torch.client.local import DfsError, LocalClient
from tpudfs_torch.gpu.hbm_reader import HbmReader, device_array_to_bytes

jax = pytest.importorskip("jax")

CPU = torch.device("cpu")
SMALL_BLOCK = 64 * 1024

#: The keys of ``bench.py``'s result dict (``bench.py:1376-1435``).
REF_KEYS = (
    "metric", "value", "unit", "vs_baseline", "windows", "write_windows",
    "value_win", "grpc_read_GBps", "grpc_read_win", "warm_infeed_read_GBps",
    "warm_infeed_win", "local_read_blocks", "confirm_s",
    "write_pipeline_GBps", "write_pipeline_win", "meta_creates_per_s",
    "meta_creates_win", "meta_fused_creates_per_s", "meta_fused_creates_win",
    "ici_write_GBps", "ici_write_win", "ici_ec_scatter_GBps",
    "ici_ec_scatter_win", "raw_infeed_GBps", "raw_infeed_win",
    "raw_infeed_after_GBps", "files", "cache_read_GBps", "cache_read_win",
    "copies_per_byte", "cache_read_p50_ms", "cache_read_p99_ms",
    "cache_read_ops", "cs_cache_hit_rate", "etag_mode", "verify_mode",
    "platform", "debug_samples",
)
#: Not ported: ``copies_per_byte`` reads the JAX package's static copy
#: ledger, which describes the reference's routes, not the port's.
NOT_PORTED = ("copies_per_byte",)


def _tick_clock():
    """A stand-in for a module's ``time``: ``perf_counter`` advances by
    exactly one second a call, so a window's GB/s is its bytes / 1e9."""
    n = iter(range(10**9))
    return types.SimpleNamespace(perf_counter=lambda: float(next(n)),
                                 monotonic=lambda: 0.0)


@pytest.fixture
def small_steps(monkeypatch):
    for mod in (bench, ref_bench):
        monkeypatch.setattr(mod, "ICI_STEP_MB", 1)
        monkeypatch.setattr(mod, "ICI_REPS", 2)
        monkeypatch.setattr(mod, "REPS", 2)


@pytest.mark.parametrize("step", ["write", "ec_scatter"])
def test_device_steps_match_the_jax_bench_window_for_window(small_steps,
                                                            monkeypatch,
                                                            step):
    port_fn, ref_fn = {
        "write": (bench.ici_write_step, ref_bench._bench_ici_write_step),
        "ec_scatter": (bench.ec_scatter_step,
                       ref_bench._bench_ec_scatter_step),
    }[step]
    monkeypatch.setattr(bench, "time", _tick_clock())
    monkeypatch.setattr(ref_bench, "time", _tick_clock())
    samples, verdicts = port_fn(CPU)
    ref_samples, ref_verdicts = ref_fn(jax.devices()[0])
    # One window = ICI_REPS rounds of 1 MiB, in both.
    assert samples == ref_samples == [2 * (1 << 20) / 1e9] * 2
    got, want = verdicts.numpy(), np.asarray(ref_verdicts)
    assert got.shape == want.shape == (2 * 2,)
    assert np.array_equal(got, want)
    assert (got == 1).all()


def _one_wrong_crc(crc32c_chunks):
    """``crc32c_chunks`` with one CRC word flipped: the step's inputs then
    carry a chunk whose recorded CRC is wrong."""
    def wrong(data):
        crcs = np.array(crc32c_chunks(data), copy=True)
        crcs[5] ^= 1
        return crcs
    return wrong


def test_write_step_flags_a_wrong_crc_as_the_jax_bench_does(small_steps,
                                                           monkeypatch):
    import tpudfs.common.checksum as ref_checksum

    monkeypatch.setattr(bench, "native", types.SimpleNamespace(
        crc32c_chunks=_one_wrong_crc(bench.native.crc32c_chunks)))
    monkeypatch.setattr(ref_checksum, "crc32c_chunks",
                        _one_wrong_crc(ref_checksum.crc32c_chunks))
    _, verdicts = bench.ici_write_step(CPU)
    _, ref_verdicts = ref_bench._bench_ici_write_step(jax.devices()[0])
    got, want = verdicts.numpy(), np.asarray(ref_verdicts)
    assert got.shape == want.shape == (2 * 2,)
    assert np.array_equal(got, want)
    assert not got.any()


@pytest.mark.parametrize("step", ["write", "ec_scatter"])
def test_run_against_fails_on_a_failed_step_verdict(small_sets, monkeypatch,
                                                    tmp_path, step):
    client = bench.lay_out_sets(tmp_path)
    if step == "write":
        monkeypatch.setattr(bench, "native", types.SimpleNamespace(
            crc32c_chunks=_one_wrong_crc(bench.native.crc32c_chunks)))
    else:
        scatter_step = bench.ec_scatter_step

        def one_ack_short(device):
            samples, acks = scatter_step(device)
            return samples, acks - (torch.arange(acks.numel()) == 1).int()

        monkeypatch.setattr(bench, "ec_scatter_step", one_ack_short)
    what = {"write": "write step", "ec_scatter": "EC scatter"}[step]
    with pytest.raises(AssertionError, match=f"{what} verification failed"):
        asyncio.run(bench.run_against(client, CPU, remote=False))


def test_device_steps_default_to_cuda(small_steps):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.ici_write_step()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.raw_infeed(None, 1024, 2)


# ------------------------------------------------------------ read windows


@pytest.fixture
def small_sets(monkeypatch, small_steps):
    monkeypatch.setattr(bench, "FILES", 8)
    monkeypatch.setattr(bench, "BLOCK_BYTES", SMALL_BLOCK)
    monkeypatch.setattr(bench, "READ_REPS", 2)
    monkeypatch.setattr(bench, "META_FILES", 10)


class _RecordingReader(HbmReader):
    """Keeps every block each read returns, and every reader made."""

    made: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.landed: list = []
        _RecordingReader.made.append(self)

    async def sweep_metas_to_device(self, *args, **kwargs):
        out = await super().sweep_metas_to_device(*args, **kwargs)
        self.landed.extend(out)
        return out

    async def read_file_to_device_blocks(self, *args, **kwargs):
        out = await super().read_file_to_device_blocks(*args, **kwargs)
        self.landed.extend(out)
        return out


@pytest.fixture
def recording(monkeypatch):
    _RecordingReader.made = []
    monkeypatch.setattr(bench, "HbmReader", _RecordingReader)
    return _RecordingReader


def _source() -> bytes:
    return np.random.default_rng(0).integers(0, 256, SMALL_BLOCK,
                                             dtype=np.uint8).tobytes()


def _flip(client: LocalClient, path: str, replicas: int) -> None:
    block = client.metas[path]["blocks"][0]
    for addr in block["locations"][:replicas]:
        store = client._local_stores[addr][0]
        p = store.block_path(block["block_id"])
        raw = bytearray(p.read_bytes())
        raw[100] ^= 0x40
        p.write_bytes(bytes(raw))


def test_read_windows_land_exact_blocks(small_sets, recording, tmp_path):
    client = bench.lay_out_sets(tmp_path)
    assert len(client.metas) == bench.REPS * 8
    r = asyncio.run(bench.run_against(client, CPU, remote=False))
    assert (r["remote"], r["platform"], r["device"]) == (False, "cpu", "cpu")
    assert (r["windows"], r["write_windows"], r["files"]) == (2, 2, 8)
    assert r["block_bytes"] == SMALL_BLOCK
    samples = r["debug_samples"]
    for kind in ("raw", "raw_pageable", "cold", "warm"):
        assert len(samples[kind]) == bench.READ_REPS, kind
    assert len(samples["ici"]) == len(samples["ec"]) == bench.REPS
    assert samples["raw_pinned"] == [None, None]  # no pinned memory on CPU
    assert r["raw_infeed_pinned_GBps"] is None
    assert r["value"] > 0 and r["vs_baseline"] > 0
    # Every window's block came through the pump: 2 windows x 8 files.
    assert r["local_read_blocks"] == 2 * 8
    for key in ("grpc_read_GBps", "write_pipeline_GBps", "cache_read_GBps",
                "etag_mode"):
        assert key not in r, key
    landed = [b for rd in recording.made for b in rd.landed]
    # 3 warm-up sweeps and 2 cold + 2 warm windows, 8 files each.
    assert len(landed) == 7 * 8
    want = _source()
    for b in landed:
        assert b.verified and b.pending_crc is None and not b.batch_pending
        assert device_array_to_bytes(b.array, b.size) == want
    assert sum(rd.rereads for rd in recording.made) == 0


@pytest.mark.parametrize("replicas", [1, 3])
def test_read_windows_recover_or_fail_a_flipped_block(small_sets, recording,
                                                      tmp_path, replicas):
    client = bench.lay_out_sets(tmp_path)
    _flip(client, bench.file_path(1, 3), replicas)
    if replicas == 3:
        with pytest.raises(DfsError, match="blk_bench_r1_f0003_0"):
            asyncio.run(bench.run_against(client, CPU, remote=False))
        return
    asyncio.run(bench.run_against(client, CPU, remote=False))
    # Set 1 is read by one cold and one warm window: the slot falls back
    # and the host-verified re-read takes the next replica, twice.
    assert sum(rd.rereads for rd in recording.made) == 2
    want = _source()
    for b in (b for rd in recording.made for b in rd.landed):
        assert b.verified
        assert device_array_to_bytes(b.array, b.size) == want


def test_remote_needs_a_cluster_client_and_rpc_call(tmp_path):
    client = LocalClient({}, {})
    with pytest.raises(TypeError, match="LocalClient has no create_file"):
        asyncio.run(bench.run_against(client, CPU, rpc_call=print))
    with pytest.raises(ValueError, match="needs rpc_call"):
        asyncio.run(bench.run_against(
            types.SimpleNamespace(create_file=None, delete_file=None,
                                  master_addrs=[]), CPU))
    assert LocalClient.local_reads is True  # never toggled


async def test_remote_windows_on_a_minicluster(small_sets, tmp_path):
    c = MiniCluster(tmp_path, n_masters=1, n_cs=3)
    try:
        await c.start()
        await c.wait_out_of_safe_mode(await c.leader())
        client = Client(list(c.masters), rpc_client=c.client,
                        block_size=SMALL_BLOCK, etag_mode="crc64")
        r = await bench.run_against(client, CPU, rpc_call=c.client.call)
    finally:
        await c.stop()
    missing = [k for k in REF_KEYS if k not in r and k not in NOT_PORTED]
    assert not missing, missing
    assert r["remote"] is True and r["etag_mode"] == "crc64"
    assert (r["windows"], r["write_windows"], r["files"]) == (2, 2, 8)
    for kind in ("raw", "grpc", "cold", "warm"):
        assert len(r["debug_samples"][kind]) == 2, kind
    assert len(r["debug_samples"]["write"]) == 2
    assert r["write_pipeline_GBps"] > 0 and r["meta_creates_per_s"] > 0
    assert r["meta_fused_creates_per_s"] > 0
    # CACHE_PASSES passes of CACHE_FILES files a window.
    assert r["cache_read_ops"] == 2 * bench.CACHE_PASSES * bench.CACHE_FILES
    assert r["grpc_read_GBps"] > 0 and r["value"] > 0
    assert r["local_read_blocks"] == 2 * 8
    assert client.local_reads is True
