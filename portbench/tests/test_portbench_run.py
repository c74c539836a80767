"""A run's result line, its look for a card, the whole-name check of the
modules it loaded, and a cell, traffic mix and metric found by name."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness, run
from portbench.tests.conftest import ROOT, SMALL

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_result_keys(run_small, bench, name):
    result, checks = run_small(name)
    assert list(result) == KEYS
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    want = {m["name"] for m in harness.metric_entries(bench, name, False)}
    assert set(result["metrics"]) == want and "setup_s" in want
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert checks and all(v <= lim for v, lim in checks.values())


@pytest.mark.parametrize("name", sorted(SMALL))
def test_traced_result_keys(run_small, bench, name):
    result, _checks = run_small(name, trace=True)
    assert list(result) == KEYS + ["breakdown"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in result["breakdown"].values())
    allowed = {m["name"] for m in harness.metric_entries(bench, name, True)}
    assert set(result["metrics"]) <= allowed
    # No device here: no device-trace metric may read a number.
    sources = {m["name"]: m["source"] for m in bench["per_layer"]}
    assert not [m for m in result["metrics"]
                if sources[m] == "device_trace"
                and not m.startswith("device.idle_share")]


def test_a_memory_peak_past_its_share_prints_no_result():
    total = 80 * 10**9
    assert run.memory_fault(int(run.MEMORY_SHARE * total), total) is None
    text = run.memory_fault(int(run.MEMORY_SHARE * total) + 1, total)
    assert "restore_shard_device" in text and str(total) in text


def test_foreign_modules_compare_whole_names(monkeypatch):
    for name in ("tpudfs_torch", "tpudfs_torch.gpu", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.foreign_modules() == []
    for name, top in (("tpudfs.master", "tpudfs"), ("jax.numpy", "jax"),
                      ("jaxlib", "jaxlib"), ("flax.linen", "flax")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in run.foreign_modules()


def test_a_run_loads_no_foreign_module(tmp_path):
    code = (
        "import sys, torch\n"
        "from portbench import run\n"
        "from portbench.tests.conftest import SMALL\n"
        "from portbench.harness import run_cell, load_json\n"
        "bench = load_json(run.ROOT / 'BENCHMARK.json')\n"
        "for name in SMALL:\n"
        "    r, _ = run_cell(bench, name, seed=5, seconds=0.2, trace=False,\n"
        "                    device=torch.device('cpu'), t_start=0.0,\n"
        "                    overrides=SMALL[name])\n"
        "    assert r['correct'], name\n"
        "print(run.foreign_modules(), sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('chip_smoke', 'tpudfs_torch')\n"
        "      and m in ('chip_smoke', 'tpudfs_torch.bench')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_without_a_card_no_result(tmp_path):
    """The look for a card: here, with no card, exit 2 and no result."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "ckpt-restore",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmark_files_is_not_enough(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ runs nothing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "ckpt-restore",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_new_files_are_found_by_name(tmp_path, monkeypatch, run_small, bench):
    """A new configuration, traffic mix and metric, added as files beside
    the others with entries in BENCHMARK.json, run with no file edited."""
    tree = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", tree,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in tree.rglob("*") if p.is_file()}
    config = json.loads((tree / "configs" / "train-host-3x.json").read_text())
    config["replication"] = 2
    (tree / "configs" / "train-host-2x.json").write_text(json.dumps(config))
    (tree / "traffic" / "unet3d-read-2.json").write_text(json.dumps(
        dict(json.loads((tree / "traffic" / "unet3d-read.json").read_text()),
             batch=2)))
    (tree / "metrics" / "infeed.samples_per_batch.py").write_text(
        "def read(ctx):\n"
        "    return sum(s.items for s in ctx.steps) / len(ctx.steps)\n")
    bench = json.loads(json.dumps(bench))
    bench["configs"].append(dict(bench["configs"][1], name="train-host-2x",
                                 file="portbench/configs/train-host-2x.json"))
    bench["workloads"].append({"name": "unet3d-2x", "config": "train-host-2x",
                               "traffic": "unet3d-read-2", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({
        "name": "infeed.samples_per_batch", "unit": "samples", "better":
        "higher", "source": "program_counter", "layer": "L1 infeed",
        "moves": "infeed_gbps", "workloads": ["unet3d-2x"]})
    for m in bench["end_to_end"]:
        if m["name"] == "infeed_gbps":
            m["workloads"].append("unet3d-2x")
    monkeypatch.setattr(harness, "HERE", tree)
    small = SMALL["unet3d-read"]
    overrides = {"config": dict(small["config"], replication=2),
                 "traffic": {"epochs": 40}}
    result, _ = run_small("unet3d-2x", bench=bench, trace=True,
                          overrides=overrides)
    assert result["correct"]
    assert result["metrics"]["infeed.samples_per_batch"]["value"] == 2
    assert all(p.read_bytes() == b for p, b in before.items())
