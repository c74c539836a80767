"""The port's slice as a whole, on the CPU at a small size: ``chip_smoke.py``'s
read path (replicated, tail and degraded RS(6,3) blocks, one confirm, a
tampered replica flagged and recovered), the rule that the port and the
smoke script import neither jax nor ``tpudfs``, and the script's refusal
to run without a card."""

import ast
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
    assert r["launches"] == {"crc32c_chunks": 0, "gf256_matmul": 0}
    assert list(tmp_path.iterdir()) == []  # the layout is removed


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
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "tpudfs" or m.startswith("tpudfs."))
assert not bad, bad
assert "tpudfs_torch.gpu.hbm_reader" in sys.modules
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
    assert len(files) >= 12
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
        assert HbmReader(client).devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HbmReader(client)
    assert HbmReader(client, [CPU]).devices == [CPU]
