"""On the card: every cell through the command, twice (the second run
finds every kernel built), and its control on three seeds.

    python3 -m pytest -s portbench/tests/test_portbench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(module: str, name: str, seed: int, *extra) -> dict:
    out = subprocess.run(
        [sys.executable, "-m", module, "--workload", name, "--seed",
         str(seed), "--seconds", "3", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(card, name):
    first = _run("portbench.run", name, 2**31 + 21, "--trace", "0")
    second = _run("portbench.run", name, 2**31 + 22, "--trace", "1")
    assert first["correct"] and second["correct"]
    assert second["device"]["busy_s"] > 0


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_on_card(card, name):
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        assert _run("portbench.control", name, seed)["correct"] is False
