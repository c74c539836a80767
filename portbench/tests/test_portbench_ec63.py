"""The erasure-coded infeed cell (``unet3d-read-ec63``) at a CPU test's
size: with any one of its nine stores lost, every data and parity index,
it comes out correct and the port rebuilds exactly the blocks whose lost
shard is a data shard; each fault the comparison must catch is caught;
the control lands the probe's flipped byte on every seed, and a sound
run's probe reads 0."""

from __future__ import annotations

import pytest
import torch

from portbench.harness import bench_path, find, load_json
from portbench.kinds import ec_samples
from tpudfs_torch.common import trace

NAME = "unet3d-read-ec63"
CPU = torch.device("cpu")
#: 64 KiB blocks and six small files: about 17 blocks, each store index
#: lost in some block whichever store is down.
SMALL = {
    "config": {"block_size": 65536, "datasets": {"unet3d": {
        "files": 6, "sample_mean_bytes": 150_000,
        "sample_std_bytes": 60_000}}},
    "traffic": {"batch": 3, "epochs": 40},
}


def _overrides(**traffic) -> dict:
    return {"config": SMALL["config"],
            "traffic": dict(SMALL["traffic"], **traffic)}


@pytest.mark.parametrize("lost", range(9))
def test_every_lost_store_is_correct_and_rebuilds_its_data_shards(
        run_small, bench, tmp_path, lost):
    result, checks = run_small(NAME, overrides=_overrides(lost_store=lost))
    assert result["correct"] is True, checks
    assert checks["tamper_wrong"][0] == 0

    # The same layout read once, every file, with the counters before and
    # after: the blocks rebuilt are those whose lost shard is a data shard.
    cell_entry = find(bench["workloads"], NAME, "workload")
    config = dict(load_json(bench_path(find(
        bench["configs"], cell_entry["config"], "config")["file"])),
        **SMALL["config"])
    traffic = dict(load_json(bench_path(f"portbench/traffic/{NAME}.json")),
                   batch=3, epochs=1, warm_batches=0, lost_store=lost)
    cell = ec_samples.Cell(config=config, traffic=traffic, seed=lost + 3,
                           device=CPU, work_dir=tmp_path)
    try:
        before = trace.counts()
        cell.setup()
        steps = [cell.step() for _ in range(len(cell.paths) // 3)]
        cell.end_window()
        after = cell.counters()
    finally:
        cell.close()
    moved = {k: v - before.get(k, 0) for k, v in after.items()}
    lost_index = [j for f in range(len(cell.paths)) for j in cell.lost_index[f]]
    assert set(lost_index) == set(range(9))
    rebuilt = sum(j < 6 for j in lost_index)
    assert moved["ec.blocks_rebuilt"] == moved["ec_rebuilds"] == rebuilt
    assert moved["ec.blocks_assembled"] == len(lost_index) - rebuilt
    assert moved["rereads"] == 0
    # Eight shards read a block: every present one, parity included.
    metas = cell.stores.metas
    assert moved["ec.shard_bytes"] == sum(
        8 * -(-b["size"] // 6) for m in metas.values() for b in m["blocks"])
    work = cell.work(steps)
    assert work["blocks"] == len(lost_index)
    assert work["verified_bytes"] == sum(cell.sizes)


@pytest.mark.parametrize("fault", ["no_verify", "altered", "half_batch",
                                   "misordered"])
def test_fault_is_not_correct(run_small, fault):
    result, checks = run_small(NAME, fault=fault, overrides=_overrides())
    assert result["correct"] is False, checks
    assert any(v > lim for v, lim in checks.values())


@pytest.mark.parametrize("seed", (1, 2**31 + 5, 2**40 + 9))
def test_control_fails_the_tamper_check(run_small, seed):
    """The control's reading: the flipped shard byte lands, on every seed."""
    _result, checks = run_small(NAME, seed=seed, fault="no_verify",
                                overrides=_overrides())
    assert checks["tamper_wrong"][0] == 1


@pytest.mark.parametrize("seed", (1, 2**31 + 5, 2**40 + 9))
def test_sound_probe_reads_zero(run_small, seed):
    result, checks = run_small(NAME, seed=seed, trace=True,
                               overrides=_overrides())
    assert checks["tamper_wrong"][0] == 0 and result["correct"] is True
    metrics = result["metrics"]
    assert 0 < metrics["ec.rebuild_share.ec63"]["value"] < 100
    assert metrics["ec.read_amplification.ec63"]["value"] > 1
    assert metrics["ec.host_ms_per_block.ec63"]["value"] > 0
