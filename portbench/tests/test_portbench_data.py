"""Each cell's inputs come from ``--seed`` alone: the same seed gives the
same bytes, tensors and orders, another seed others, and every seed the
same sizes."""

from __future__ import annotations

import pytest
import torch

from portbench import data

CPU = torch.device("cpu")
SEEDS = (0, 7, 2**31 + 7, 2**40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_bytes_repeat_from_the_seed(seed):
    a = data.random_bytes(10_001, seed, "sample3", CPU)
    assert a.dtype == torch.uint8 and a.numel() == 10_001
    assert torch.equal(a, data.random_bytes(10_001, seed, "sample3", CPU))
    assert not torch.equal(a, data.random_bytes(10_001, seed + 1, "sample3",
                                                CPU))
    assert not torch.equal(a, data.random_bytes(10_001, seed, "sample4", CPU))


@pytest.mark.parametrize("seed", SEEDS)
def test_ckpt_tree_repeats_from_the_seed(seed):
    a = data.ckpt_tree(1000, 13, seed, CPU)
    b = data.ckpt_tree(1000, 13, seed, CPU)
    assert sorted(a) == ["adam_m", "adam_v", "flags", "model", "params", "step"]
    assert a["model"].dtype == torch.bfloat16 and a["flags"].dtype == torch.int8
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["params"], data.ckpt_tree(1000, 13, seed + 1,
                                                       CPU)["params"])


def test_sizes_are_one_set_for_every_seed():
    sizes = data.normal_sizes(146_600_628, 68_341_808, 16)
    assert sizes == data.normal_sizes(146_600_628, 68_341_808, 16)
    assert min(sizes) > 0 and sorted(sizes) == sizes
    assert abs(sum(sizes) / 16 - 146_600_628) < 1
    orders = {tuple(data.permutation(16, s, "sizes")) for s in SEEDS}
    assert len(orders) == len(SEEDS)
    assert data.permutation(16, 5, "epoch0") == data.permutation(16, 5, "epoch0")


def test_sub_seeds_fit_every_generator():
    for seed in (*SEEDS, -5, 2**63 + 1):
        s = data.sub_seed(seed, "shuffle")
        assert 0 <= s < 2**63
        torch.Generator().manual_seed(s)
    assert data.sub_seed(-5, "x") != data.sub_seed(5, "x")
