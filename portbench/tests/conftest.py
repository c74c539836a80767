"""Fixtures of the benchmark's own tests (``python3 -m pytest portbench/tests``).

Tests marked ``card`` need a CUDA card; the ``card`` fixture skips them
elsewhere, deciding when the test runs, never when a module is imported.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

#: Each cell at a size a CPU test holds: 64 KiB blocks, small files and a
#: small shard; everything else as the cell's own files give it.
SMALL = {
    "ckpt-restore": {"config": {"block_size": 65536, "checkpoint": {
        "params_total": 128 * 40_000, "ranks": 128, "flags_elements": 13}}},
    "ckpt-restore-cold": {"config": {"block_size": 65536, "checkpoint": {
        "params_total": 128 * 40_000, "ranks": 128, "flags_elements": 13}}},
    "unet3d-read": {
        "config": {"block_size": 65536, "datasets": {"unet3d": {
            "files": 6, "sample_mean_bytes": 150_000,
            "sample_std_bytes": 60_000}}},
        "traffic": {"batch": 3, "epochs": 40}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def bench() -> dict:
    """``BENCHMARK.json``."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def run_small(bench):
    """Run a cell once on the CPU at its small size."""
    from portbench.harness import run_cell
    from portbench.trace import clock

    def run(name, *, seed=2**31 + 11, seconds=0.3, trace=False, fault=None,
            bench=bench, overrides=None):
        return run_cell(bench, name, seed=seed, seconds=seconds, trace=trace,
                        device=torch.device("cpu"), t_start=clock(),
                        fault=fault, overrides=overrides or SMALL[name])

    return run
