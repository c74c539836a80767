"""The comparison that decides ``correct`` fails each fault a cell can
have, planted in the port under a run at the cells' small sizes: the
control (the integrity guarantee broken), a byte altered where it is
produced, a restore that returns its state unchanged, half of each batch
left out, and batches out of order. (One card: no exchange between chips
to leave out.)"""

from __future__ import annotations

import pytest

CASES = [
    ("ckpt-restore", "no_verify"), ("ckpt-restore", "altered"),
    ("ckpt-restore", "unchanged"),
    ("ckpt-restore-cold", "no_verify"), ("ckpt-restore-cold", "altered"),
    ("ckpt-restore-cold", "unchanged"),
    ("unet3d-read", "no_verify"), ("unet3d-read", "altered"),
    ("unet3d-read", "half_batch"), ("unet3d-read", "misordered"),
]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(run_small, name, fault):
    result, checks = run_small(name, fault=fault)
    assert result["correct"] is False, checks
    assert any(v > lim for v, lim in checks.values())


@pytest.mark.parametrize("seed", (1, 2**31 + 5, 2**40 + 9))
def test_control_fails_the_tamper_check(run_small, seed):
    """The control's reading: the flipped byte lands, on every seed."""
    for name in ("ckpt-restore", "ckpt-restore-cold", "unet3d-read"):
        _result, checks = run_small(name, seed=seed, fault="no_verify")
        assert checks["tamper_wrong"][0] == 1, name
