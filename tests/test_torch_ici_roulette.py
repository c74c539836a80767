"""The write-group soak, ``tpudfs_torch.ici_roulette`` (counterpart of
``scripts/ici_roulette.py``), on the reference ``InprocCluster`` with the
port's group on three CPU positions, in an interpreter that cannot import
JAX.

One round per fault kind, forced with ``plan=[kind]``: the fault must bite,
every acked put must read back byte-exact through a fresh client, no block
of a failed round may be on a member's disk, and the re-healed group must
carry the post-fault put in a round. Then two unforced rounds of
``roulette(seed=42)``. Every round runs in one subprocess (one interpreter
start), each reporting its result or its error."""

import pytest

from tpudfs_torch.ici_roulette import KINDS
from torch_nojax import run_without_jax


@pytest.fixture(scope="module")
def soak():
    return run_without_jax('''
        import random
        import torch
        from tpudfs.testing.inproc import InprocCluster
        from tpudfs_torch.ici_roulette import KINDS, roulette, run_round

        devices = [torch.device("cpu")] * 3
        result = {}

        def job(name, fn):
            try:
                result[name] = fn()
            except Exception as e:
                result[name] = {"error": f"{type(e).__name__}: {e}"}

        for i, kind in enumerate(KINDS, 1):
            job(kind, lambda: run_round(
                devices, InprocCluster, i, random.Random((42 << 16) ^ i), 42,
                plan=[kind]))
        job("roulette", lambda: roulette(devices, InprocCluster, rounds=2,
                                         seed=42))
    ''', timeout=300)


def test_soak_loads_no_jax(soak):
    assert soak["loaded_jax"] == []


@pytest.mark.parametrize("kind", KINDS)
def test_forced_fault_bites_and_the_group_recovers(soak, kind):
    r = soak[kind]
    assert "error" not in r, r
    assert r["plan"] == [kind] and r["bit"] == [kind] and r["missed"] == []
    assert r["puts_checked"] >= 24
    # The re-healed group carried rounds before and after the fault.
    assert r["rounds"] >= 2 and r["blocks"] >= 2
    if kind == "detach":
        assert r["fallbacks"] >= 1
    else:
        # The failed round's blocks fell back to the TCP chain, and none of
        # them was on a member's disk when the round failed.
        assert r["round_failures"] >= 1 and r["failed_blocks"] >= 1
        assert r["fallbacks"] >= r["failed_blocks"]


def test_unforced_roulette(soak):
    rounds = soak["roulette"]
    assert not isinstance(rounds, dict), rounds
    assert [r["round"] for r in rounds] == [1, 2]
    for r in rounds:
        assert 1 <= len(r["plan"]) <= 3 and set(r["plan"]) <= set(KINDS)
        assert r["puts_checked"] >= 24 and r["rounds"] >= 2
